"""Serving launcher of the port: the continuous-batching engine over one
tenant with a paged KV cache, monolithic prefill and fused sampling
(`--engine`), or one forward of the ARAS layer-streaming executor, whose
arena holds only `--arena-slots` layers (`--streaming`).

    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --arch gemma-7b --requests 8 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --engine --smoke \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --streaming \
        --arch gemma-7b --arena-slots 3 --batch 4 --prompt-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --streaming --smoke \
        --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.nn.model import init_params
from repro_torch.serving import (EngineModel, SchedulerConfig, ServingEngine,
                                 format_summary)


def _run_engine(args) -> None:
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(cfg, seed=0, device=args.device)
    eng = ServingEngine(
        [EngineModel("tenant-a", params, cfg, kv_slots=args.kv_slots,
                     max_seq=args.prompt_len + args.gen + 8,
                     page_size=args.page_size)],
        sched=SchedulerConfig(max_prefill_per_step=4), device=args.device)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        plen = int(rng.integers(max(args.prompt_len // 2, 2),
                                args.prompt_len + 1))
        eng.submit("tenant-a", rng.integers(1, cfg.vocab, plen).tolist(),
                   max_new_tokens=args.gen)
    summary = eng.run()
    print(f"engine: {args.requests} requests, {args.kv_slots} decode rows, "
          f"page size {args.page_size}, on {eng.device}")
    print(format_summary(summary))


def _run_streaming(args) -> None:
    """`repro.launch.serve --streaming`: one streamed forward over a batch
    of random tokens drawn from a numpy Generator(--seed)."""
    import torch
    from repro_torch.streaming.executor import StreamingExecutor
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(cfg, seed=0, device=args.device)
    ex = StreamingExecutor(params, cfg, arena_slots=args.arena_slots,
                           plan_tokens=args.batch * args.prompt_len,
                           device=args.device)
    del params
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    batch = {"tokens": torch.as_tensor(tokens, device=ex.device)}
    _, m = ex.forward(batch)
    print(f"streaming forward: {m['wall_s']*1e3:.1f} ms, "
          f"wire {m['wire_bytes']/1e6:.2f} MB vs raw "
          f"{m['raw_bytes']/1e6:.2f} MB "
          f"(skip {m['mean_skip']:.1%}, center={int(m['reuse_center'])}); "
          f"plan overlap speedup {m['plan_overlap_speedup']:.2f}×")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCHS, default="gemma-7b")
    p.add_argument("--smoke", action="store_true")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--engine", action="store_true",
                      help="continuous-batching engine")
    mode.add_argument("--streaming", action="store_true",
                      help="one forward of the layer-streaming executor")
    p.add_argument("--arena-slots", type=int, default=3,
                   help="streaming: layers the device arena holds")
    p.add_argument("--batch", type=int, default=4,
                   help="streaming: sequences in the batch")
    p.add_argument("--seed", type=int, default=0,
                   help="streaming: seed of the random prompt tokens")
    p.add_argument("--kv-slots", type=int, default=4,
                   help="decode rows of the tenant")
    p.add_argument("--page-size", type=int, default=8,
                   help="tokens per KV page")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--requests", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the plain kernel versions)")
    return p


def main() -> None:
    args = _parser().parse_args()
    (_run_streaming if args.streaming else _run_engine)(args)


if __name__ == "__main__":
    main()
