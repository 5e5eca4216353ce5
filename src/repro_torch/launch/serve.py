"""Serving launcher of the port: the continuous-batching engine over one
tenant with a paged KV cache, monolithic prefill and fused sampling.

    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --arch gemma-7b --requests 8 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --engine --smoke \
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


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCHS, default="gemma-7b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--engine", action="store_true", required=True,
                   help="continuous-batching engine (the only mode ported)")
    p.add_argument("--kv-slots", type=int, default=4,
                   help="decode rows of the tenant")
    p.add_argument("--page-size", type=int, default=8,
                   help="tokens per KV page")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--requests", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the plain kernel versions)")
    _run_engine(p.parse_args())


if __name__ == "__main__":
    main()
