"""Serving launcher of the port: the continuous-batching engine over two
tenants with a paged KV cache, monolithic prefill and fused sampling,
tenant-b a perturbed variant of tenant-a, both behind one ARAS weight
arena of `--weight-slots` layers (`--engine`); or one forward of the ARAS
layer-streaming executor, whose arena holds only `--arena-slots` layers
(`--streaming`).

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
from repro_torch.serving import (EngineModel, InstallCostModel,
                                 SchedulerConfig, ServingEngine,
                                 format_summary)
from repro_torch.serving.variants import perturbed_variant


def _run_engine(args) -> None:
    """`repro.launch.serve --engine` on the paged layout: two tenants,
    tenant-b a perturbed variant of tenant-a (the co-hosted fine-tune
    regime where cross-tenant §V-C delta installs have real structure),
    in a weight arena smaller than both tenants' layer sets, so a tenant
    switch installs layers; requests alternate between the tenants."""
    cfg = get_config(args.arch, smoke=args.smoke)
    base = init_params(cfg, seed=0, device=args.device)
    variant = perturbed_variant(base)
    kv = dict(kv_slots=args.kv_slots, max_seq=args.prompt_len + args.gen + 8,
              page_size=args.page_size)
    tenants = [EngineModel("tenant-a", base, cfg, **kv),
               EngineModel("tenant-b", variant, cfg, **kv)]
    weight_slots = args.weight_slots or cfg.n_layers + 1
    eng = ServingEngine(
        tenants, weight_arena_slots=weight_slots,
        sched=SchedulerConfig(max_prefill_per_step=4,
                              model_turn_steps=args.turn_steps),
        install_ticks_per_step=args.install_ticks_per_step,
        overlap_installs=args.overlap_installs,
        install_cost=InstallCostModel(
            bytes_per_tick=args.install_bytes_per_tick),
        device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        model = tenants[i % len(tenants)].name
        plen = int(rng.integers(max(args.prompt_len // 2, 2),
                                args.prompt_len + 1))
        eng.submit(model, rng.integers(1, cfg.vocab, plen).tolist(),
                   max_new_tokens=args.gen)
    summary = eng.run()
    print(f"engine: {args.requests} requests across {len(tenants)} models, "
          f"{args.kv_slots} KV slots each, weight arena {weight_slots} "
          f"slots, page size {args.page_size}, on {eng.device}")
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
                   help="engine: decode rows of each tenant")
    p.add_argument("--weight-slots", type=int, default=0,
                   help="engine: weight arena slots (0 = n_layers+1)")
    p.add_argument("--turn-steps", type=int, default=8,
                   help="engine: tenant time-slice length in steps")
    p.add_argument("--install-ticks-per-step", type=int, default=0,
                   help="engine: weight-install tick budget per step "
                        "(0 = instant installs at the turn boundary)")
    p.add_argument("--install-bytes-per-tick", type=int, default=1 << 16,
                   help="engine: wire bytes one install tick moves")
    p.add_argument("--overlap-installs", action="store_true",
                   help="engine: pipeline the next tenant's weight installs "
                        "under the current tenant's final decode steps "
                        "(needs --install-ticks-per-step > 0)")
    p.add_argument("--page-size", type=int, default=8,
                   help="tokens per KV page")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--requests", type=int, default=10,
                   help="engine: number of requests to submit")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the plain kernel versions)")
    return p


def main() -> None:
    args = _parser().parse_args()
    (_run_streaming if args.streaming else _run_engine)(args)


if __name__ == "__main__":
    main()
