"""Example, PyTorch port: ARAS-style serving when weights exceed the device
arena.

Part 1 streams a single model through the layer-streaming executor
(delta-encoded INT8 installs overlapped with compute) and checks the result
against the resident full model.

Part 2 serves two tenants — a base model and a fine-tuned variant — through
the continuous-batching `ServingEngine` on a weight arena too small to hold
both, so every tenant switch delta-installs layer codes §V-C-style across
tenants.

Part 3 switches the KV cache to the paged layout: requests sharing a system
prompt share physical KV pages (copy-on-write on divergence), and one
request runs far past the slot layout's per-request `max_seq` ceiling.

The streaming plan's makespan is projected on one H100's host link
(`repro_torch.streaming.plan.LinkModel`).

    PYTHONPATH=src python examples/serve_stream_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.nn.model import forward, init_params
from repro_torch.serving import EngineModel, SchedulerConfig, ServingEngine, format_summary
from repro_torch.serving.variants import perturbed_variant
from repro_torch.streaming.executor import StreamingExecutor


def main(device: str = "cuda") -> None:
    cfg = get_config("gemma-7b", smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=6, scan_layers=False)
    params = init_params(cfg, seed=0, device=device)
    batch = {"tokens": torch.ones((2, 24), dtype=torch.int32, device=device)}

    # --- 1. layer streaming: 6 layers through 3 arena slots -------------
    ex = StreamingExecutor(params, cfg, arena_slots=3, reuse=True,
                           plan_tokens=2 * 24, device=device)
    logits, m = ex.forward(batch)
    ref, _, _ = forward(params, batch, cfg)
    err = float((logits.float() - ref.float()).abs().max())
    print(f"streamed forward matches resident model to {err:.4f} (INT8 noise)")
    print(f"installs: {int(m['raw_bytes'])} raw bytes -> "
          f"{int(m['wire_bytes'])} wire bytes "
          f"(skip ratio {m['mean_skip']:.1%}, center={int(m['reuse_center'])})")
    print(f"plan: overlap speedup {m['plan_overlap_speedup']:.2f}× vs naive, "
          f"projected makespan {m['plan_makespan_s']*1e3:.2f} ms on H100 link")

    # --- 2. two tenants through the continuous-batching engine ----------
    rng = np.random.default_rng(0)
    variant = perturbed_variant(params)
    eng = ServingEngine(
        [EngineModel("base", params, cfg, kv_slots=3, max_seq=40),
         EngineModel("variant", variant, cfg, kv_slots=3, max_seq=40)],
        weight_arena_slots=cfg.n_layers + 2,   # < 2 models -> tenant swaps
        sched=SchedulerConfig(model_turn_steps=4), device=device)
    for i in range(6):
        prompt = rng.integers(1, cfg.vocab, int(rng.integers(4, 12))).tolist()
        eng.submit("base" if i % 2 == 0 else "variant", prompt,
                   max_new_tokens=6)
    print("\nserving 6 requests across 2 tenants (continuous batching):")
    print(format_summary(eng.run()))

    # --- 3. paged KV: shared prefixes + no per-request max_seq ----------
    peng = ServingEngine(
        [EngineModel("base", params, cfg, kv_slots=4, max_seq=16,
                     kv_layout="paged", page_size=4, n_pages=24)],
        device=device)
    sys_prompt = rng.integers(1, cfg.vocab, 9).tolist()   # 2 full + 1 partial page
    for _ in range(3):   # same system prompt -> shared pages, COW on divergence
        peng.submit("base", sys_prompt, max_new_tokens=5)
    # 3× past the slot layout's max_seq=16 ceiling: just more pages
    long_req = peng.submit("base", rng.integers(1, cfg.vocab, 24).tolist(),
                           max_new_tokens=24)
    # temperature sampling rides along (seeded per-request PRNG)
    sampled = peng.submit("base", sys_prompt, max_new_tokens=5,
                          temperature=0.8, top_k=16, seed=7)
    print("\nserving 5 requests through the paged KV arena "
          "(page_size=4, 24 pages):")
    print(format_summary(peng.run()))
    print(f"long request spanned {long_req.prompt_len + 24} tokens "
          f"(slot arena ceiling was 16); sampled request: "
          f"{sampled.generated}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    main(ap.parse_args().device)
