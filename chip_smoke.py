"""Chip smoke test of the PyTorch port on one NVIDIA GPU (written for an
H100).  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. print the card's name and power limit, build every CUDA kernel from
     the sources in this checkout (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version at the serving
     path's shapes, and time kernel, plain version and the PyTorch library
     call where one computes the same function;
  3. serve requests through the port's engine at gemma-7b's full width
     (28 layers, seeded random weights), counting kernel launches;
  4. hold the first decode step's logits computed with the kernels against
     the same step through the plain versions, on the card, and profile a
     few decode steps (host wall time against device time, top kernels);
  5. print the `kernels` JSON line, then the result line.

The script imports nothing of JAX or of the JAX package.  Exits non-zero
without a result when no CUDA device is visible.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
KERNEL_TOL = 2e-2              # bf16 output: the reference's own tolerance
# Logits after 28 bf16 layers: kernel and plain version round each layer's
# attention output at different points (online vs two-pass softmax, f32 sums
# in another order), which moves a few elements by one bf16 ulp (2**-8
# relative) per layer; random-weight layers amplify such differences, and
# the first chip run measured ~2% of the logit scale.  5% of the largest
# logit bounds that noise while a wrong kernel (a missed page, a wrong
# mask) moves logits by their own scale.
LOGIT_TOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn` in ms over `iters` calls after a warm-up,
    by CUDA events around the whole run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 2
def check_paged(torch, B, H, Hkv, D, page, T, seed):
    """Kernel vs plain on a pool whose every position past a row's pos —
    inside its live page and in its later pages — holds 1e4 garbage."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * T + 1
    q = torch.randn(B, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(P, page, Hkv, D, generator=g, device=dev).bfloat16()
    v = torch.randn(P, page, Hkv, D, generator=g, device=dev).bfloat16()
    perm = torch.randperm(P - 1, generator=g, device=dev)[:B * T] + 1
    tables = perm.view(B, T).to(torch.int32)
    cap = T * page
    pos_list = [0, page - 1, page, 3 * page + 5, cap // 2 + 7, cap - page,
                cap - 2, cap - 1][:B]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    for b, p in enumerate(pos_list):       # stale garbage past each pos
        pages = tables[b].long()
        flat_k = k[pages].view(cap, Hkv, D)
        flat_v = v[pages].view(cap, Hkv, D)
        flat_k[p + 1:] = 1e4
        flat_v[p + 1:] = 1e4
        k[pages] = flat_k.view(T, page, Hkv, D)
        v[pages] = flat_v.view(T, page, Hkv, D)
    out = paged_attention(q, k, v, tables, pos)
    ref = paged_attention_plain(q, k, v, tables, pos)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= KERNEL_TOL and torch.isfinite(out).all()):
        raise AssertionError(f"paged_attention kernel disagrees: max abs "
                             f"err {err} > {KERNEL_TOL}")
    ms = cuda_ms(lambda: paged_attention(q, k, v, tables, pos), 50)
    plain_ms = cuda_ms(lambda: paged_attention_plain(q, k, v, tables, pos), 5)
    # no single PyTorch call pages; as a yardstick only, SDPA over K/V
    # already gathered into rows (the gather itself not timed)
    kg, vg = (x[tables.long()].view(B, cap, Hkv, D).transpose(1, 2)
              for x in (k, v))
    mask = (torch.arange(cap, device=dev)[None, :]
            <= pos[:, None]).view(B, 1, 1, cap)
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q.view(B, H, 1, D), kg, vg, attn_mask=mask,
        enable_gqa=H != Hkv), 50)
    live = sum(p + 1 for p in pos_list)
    live_pages = sum(p // page + 1 for p in pos_list)
    n_bytes = (2 * B * H * D * 2 + 2 * live * Hkv * D * 2
               + live_pages * 4 + B * 4)
    n_flops = 4 * live * H * D
    return err, ms, plain_ms, sdpa_ms, bound_ms(n_bytes, n_flops)


def check_flash(torch, S, H, D, seed, Hkv=None):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    Hkv = Hkv or H
    q = torch.randn(1, S, H, D, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(1, S, Hkv, D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= KERNEL_TOL and torch.isfinite(out).all()):
        raise AssertionError(f"flash_attention kernel disagrees at S={S}: "
                             f"max abs err {err} > {KERNEL_TOL}")
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=H != Hkv), 20)
    n_bytes = 2 * S * (H + Hkv) * D * 2
    n_flops = 2 * D * H * S * (S + 1)
    return err, ms, plain_ms, lib_ms, bound_ms(n_bytes, n_flops)


# ------------------------------------------------------------ phase 3
def serve(torch, cfg, params, requests, page):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.serving import (EngineModel, SchedulerConfig,
                                     ServingEngine, format_summary)
    max_seq = max(len(p) + n for p, n, _ in requests)
    n_pages = len(requests) * -(-max_seq // page)
    eng = ServingEngine(
        [EngineModel("gemma-7b", params, cfg, kv_slots=8, max_seq=max_seq,
                     page_size=page, n_pages=n_pages)],
        sched=SchedulerConfig(max_prefill_per_step=4), device="cuda")
    for prompt, n_new, sampling in requests:
        eng.submit("gemma-7b", prompt, max_new_tokens=n_new, **sampling)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    summary = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": paged_attention.launches,
                "flash_attention": flash_attention.launches}
    reqs = list(eng.requests.values())
    if not all(r.status.value == "finished"
               and len(r.generated) == r.max_new_tokens for r in reqs):
        raise AssertionError("not every request finished: " + ", ".join(
            f"{r.rid}:{r.status.value}:{len(r.generated)}" for r in reqs))
    for r in reqs:
        if not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"request {r.rid} emitted a token outside "
                                 f"the vocab: {r.generated}")
    decode_batches = sum(1 for s in eng.metrics.steps if s.n_decoded)
    prefills = sum(s.n_prefills for s in eng.metrics.steps)
    if launches["paged_attention"] != cfg.n_layers * decode_batches:
        raise AssertionError(f"paged kernel launched {launches} times, want "
                             f"{cfg.n_layers} x {decode_batches} batches")
    if launches["flash_attention"] != cfg.n_layers * prefills:
        raise AssertionError(f"flash kernel launched {launches} times, want "
                             f"{cfg.n_layers} x {prefills} prefills")
    tokens = sum(len(r.generated) for r in reqs)
    log(format_summary(summary))
    log(f"serve: {len(reqs)} requests, {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:.1f} tok/s; {len(eng.metrics.steps)} steps, mean "
        f"step {wall / len(eng.metrics.steps) * 1e3:.1f} ms; "
        f"{decode_batches} decode batches, {prefills} prefills; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches in the serve run: {json.dumps(launches)}")
    del eng
    return launches


# ------------------------------------------------------------ phase 4
def first_step_logits(torch, cfg, params, requests, page):
    """Prefill the prompts into a fresh arena, then run the first batched
    decode step twice on identical pools: through the kernels, and with
    both wrappers swapped for their plain versions.  Prefill logits are
    compared the same way."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    from repro_torch.launch.steps import paged_serve_step, prefill_step
    from repro_torch.nn import attention as attn_mod
    from repro_torch.serving.paging import PagedKVArena
    from repro_torch.tree import tree_leaves
    plain = mock.patch.multiple(attn_mod, paged_attention=lambda *a: (
        paged_attention_plain(*a)), flash_attention=lambda q, k, v, causal: (
        flash_attention_plain(q, k, v, causal)))
    max_seq = max(len(p) + n for p, n, _ in requests)
    arena = PagedKVArena(cfg, 8, 8 * -(-max_seq // page), page,
                         device="cuda")
    pre_err = 0.0
    for rid, (prompt, _, _) in enumerate(requests[:8]):
        row = arena.alloc(rid, tuple(prompt))
        tokens = torch.tensor([prompt], device="cuda")
        bucket = arena.blocks_for(len(prompt)) * page
        logits, one = prefill_step(params, tokens, cfg, bucket)
        with plain:
            logits_p, _ = prefill_step(params, tokens, cfg, bucket)
        pre_err = max(pre_err, (logits.float() - logits_p.float()).abs()
                      .max().item())
        arena.install(row, one, int(logits[0, :cfg.vocab].argmax()),
                      tuple(prompt))
    for row in arena.active_slots():
        assert arena.prepare_decode(row)
    saved = [t.clone() for t in tree_leaves(arena.caches)]
    tok, pos, tables = arena.decode_inputs()
    k_logits, _ = paged_serve_step(params, tok, arena.caches, pos, tables,
                                   cfg)
    for t, s in zip(tree_leaves(arena.caches), saved):
        t.copy_(s)
    with plain:
        p_logits, _ = paged_serve_step(params, tok, arena.caches, pos,
                                       tables, cfg)
    k32, p32 = k_logits.float()[:, :cfg.vocab], p_logits.float()[:, :cfg.vocab]
    if not (torch.isfinite(k32).all() and k32.shape == (8, cfg.vocab)):
        raise AssertionError("decode logits not finite / wrong shape")
    dec_err = (k32 - p32).abs().max().item()
    scale = p32.abs().max().item()
    agree = (k32.argmax(-1) == p32.argmax(-1)).float().mean().item()
    return pre_err, dec_err, scale, agree, arena


def profile_decode(torch, cfg, params, arena, steps=5):
    """Where a decode step's time goes: host wall time per step (ending in
    a synchronize) against the device time the profiler attributes to
    kernels, and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import paged_serve_step
    tok, pos, tables = arena.decode_inputs()

    def step():
        paged_serve_step(params, tok, arena.caches, pos, tables, cfg)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # device-side entries (kernels, copies) only: the CPU ops that launched
    # them carry the same device time again
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    n_ops = sum(e.count for e in averages
                if e.device_type == DeviceType.CPU
                and e.key.startswith("aten::")) // steps
    log(f"decode step (8 rows, {cfg.n_layers} layers): {wall_ms:.2f} ms "
        f"wall, {device_ms:.2f} ms device ({device_ms / wall_ms:.1%} busy), "
        f"{sum(e.count for e in kernels) // steps} kernels and {n_ops} aten "
        f"calls per step; weight-read bound "
        f"{cfg.param_count() * 2 / HBM_BYTES_PER_S * 1e3:.2f} ms")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        log(f"  {e.device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{e.count // steps:5d}x  {e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.nn.model import init_params

    # phase 1: build
    t0 = time.perf_counter()
    build.build_all()
    log(f"built {', '.join(build.NAMES)} in {time.perf_counter() - t0:.1f} s")
    for name in build.NAMES:
        for line in build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")

    # phase 2: kernels against their plain versions
    p_err, p_ms, p_plain, p_sdpa, (p_bound, p_by) = check_paged(
        torch, B=8, H=16, Hkv=16, D=256, page=16, T=64, seed=1)
    log(f"paged_attention B8 Hkv16 G1 D256 page16 T64: err {p_err:.3g}, "
        f"{p_ms:.4f} ms (plain {p_plain:.4f} ms, sdpa over pre-gathered K/V "
        f"{p_sdpa:.4f} ms), bound {p_bound:.4f} ms by {p_by}")
    g_err, g_ms, g_plain, g_sdpa, (g_bound, g_by) = check_paged(
        torch, B=8, H=16, Hkv=4, D=128, page=16, T=64, seed=2)
    log(f"paged_attention B8 Hkv4 G4 D128 page16 T64: err {g_err:.3g}, "
        f"{g_ms:.4f} ms (plain {g_plain:.4f} ms, sdpa over pre-gathered K/V "
        f"{g_sdpa:.4f} ms), bound {g_bound:.4f} ms by {g_by}")
    err = check_flash(torch, S=77, H=8, D=64, seed=3, Hkv=2)[0]
    log(f"flash_attention S77 H8 Hkv2 D64 causal (GQA, ragged): err "
        f"{err:.3g}")
    err = check_paged(torch, B=3, H=4, Hkv=2, D=32, page=4, T=6, seed=4)[0]
    log(f"paged_attention B3 Hkv2 G2 D32 page4 T6: err {err:.3g}")
    flash = {}
    for S in (512, 1000):
        flash[S] = check_flash(torch, S=S, H=16, D=256, seed=S)
        err, ms, plain_ms, lib_ms, (b, by) = flash[S]
        log(f"flash_attention S{S} H16 D256 causal: err {err:.3g}, "
            f"{ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms), "
            f"bound {b:.4f} ms by {by}")

    # phase 3: serve at gemma-7b's full width
    cfg = get_config("gemma-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"init_params {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    requests = []
    for i in range(8):
        n = int(rng.integers(32, 513))
        sampling = (dict(temperature=0.8, top_k=40, seed=7) if i == 3
                    else {})
        requests.append((rng.integers(1, cfg.vocab, n).tolist(),
                         int(rng.integers(16, 33)), sampling))
    launches = serve(torch, cfg, params, requests, page=16)

    # phase 4: first decode step, kernels against plain versions
    pre_err, dec_err, scale, agree, arena = first_step_logits(
        torch, cfg, params, requests, page=16)
    log(f"first-step logits, kernels vs plain: prefill max abs err "
        f"{pre_err:.4g}, decode max abs err {dec_err:.4g} (logit scale "
        f"{scale:.4g}, tolerance {LOGIT_TOL:.0%} of it), greedy agreement "
        f"{agree:.3f}")
    if not max(pre_err, dec_err) <= LOGIT_TOL * scale:
        raise AssertionError("first-step logits: kernels and plain versions "
                             "differ beyond the tolerance")
    profile_decode(torch, cfg, params, arena)

    # phase 5: report
    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/paged_attention/csrc/"
                   "paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:70",
         "launches": launches["paged_attention"], "max_abs_err": p_err,
         "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound,
         "bound_by": p_by, "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:67",
         "launches": launches["flash_attention"], "max_abs_err": flash[512][0],
         "ms": flash[512][1], "plain_ms": flash[512][2],
         "bound_ms": flash[512][4][0], "bound_by": flash[512][4][1],
         "library_ms": flash[512][3]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
