"""Chip smoke test of the PyTorch port on one NVIDIA GPU (written for an
H100).  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. print the card's name and power limit, build every CUDA kernel from
     the sources in this checkout (one nvcc per source, in parallel), and
     count the tensor-core instructions (wgmma HGMMA/IGMMA, mma.sync
     HMMA/IMMA) in each library's SASS: crossbar_mvm, flash_attention and
     flash_attention_f32 (split TF32) must have some, paged_attention_f32
     (f32 FMAs) none;
  2. hold each kernel against its plain PyTorch version at the shapes its
     path gives it and at the shapes its design finds hard (paged: stale
     garbage past every row's position, G 1 to 16, head dims 8 to 256,
     rows of 8,192 tokens, timed cold, phase 8's page views of contiguous
     caches, phase 9's tables with retired pages skipped, hymba-1.5b's G 5
     D 64 over phase 11's rows; flash: every native head dim and the
     zero-padded ones, GQA up to G 16, ragged, causal and full, S 512 and
     1000, the streaming B 4 x S 512, hymba-1.5b's S 1,536 H 25 Hkv 5;
     the f32 attention kernels against plain versions whose products
     stay in full f32, paged at 3e-4
     (every untimed shape above, the long tables and their split plans;
     the serve run's shape, G 4 and G 16 timed), flash at 3e-5, ten times
     tighter, on inputs where one TF32 pass is shown to miss it;
     delta_apply in place and out of place; crossbar: ragged tiles, a K
     that is not a multiple of 16 at M < 64), and time kernel, plain
     version and the PyTorch
     library call where one computes the same function;
  3. serve requests through the port's paged engine at gemma-7b's full
     width (28 layers, seeded random weights), counting kernel launches;
  4. hold the first decode step's logits computed with the kernels against
     the same step through the plain versions, on the card, and profile a
     few decode steps and the longest prompt's prefill step (host wall
     time against device time, top kernels);
  5. stream the same gemma-7b through the ARAS layer-streaming executor
     (3 arena slots, batch 4 x 512 tokens): one forward through the kernels
     (delta_apply, pulse_count, flash_attention launches counted, device
     time profiled), one more with every install's slot codes held against
     the store's, and one with the install kernels swapped for their plain
     versions — logits and per-install pulse counts must be identical;
     then the crossbar int8 matmul path on that store's real codes;
  6. serve two gemma-7b tenants at full width, tenant-b a perturbation of
     tenant-a: once with every layer resident, once through an ARAS weight
     arena of n_layers + 1 slots (reuse on, the install pipeline overlapped
     with decode, turns of 8 steps), counting paged, flash and pulse_count
     launches and timing every pair cost the install greedy computes; the
     greedy tokens of the two runs must be equal, and three committed
     cross-tenant pair costs must equal their recomputation through the
     plain pulse_count;
  7. chunked prefill at gemma-7b's full width: phase 3's requests through
     the engine with chunks of 256 under a 512-token step budget and the
     prefix cache on (no flash launch, 28 paged launches a decode batch;
     each chunk's shape and wall time, TTFT, greedy agreement with phase
     3), the longest prompt's last-chunk logits against the monolithic
     prefill's, a profiled chunk step; then four requests over one
     1,024-token shared prefix, the first run alone, warm (prefix cache
     on) and cold (off): 3 x 1,024 hit tokens warm, 0 cold, prompt
     tokens computed 3 x 1,024 apart, the same greedy tokens;
  8. the slot KV layout, the reference's default, at gemma-7b's full
     width: phase 3's requests through one slot tenant (8 slots of 552 =
     512 + 32 + 8 tokens; the decode attention is the paged kernel over
     each slot seen as 69 pages of 8 tokens): 28 paged launches a decode
     batch, 224 flash launches, none of the other three kernels, every
     first token equal to phase 3's; one slot decode step through the
     kernels against the plain versions, profiled; the launcher's default
     mode (prefill-then-greedy, batch 4 x 512 tokens, 32 new) through the
     function the CLI calls, then its prefill and every decode step rerun
     on its tokens through the kernels and through the plain versions,
     logits held within LOGIT_TOL; and the CLI's
     default `--engine` at smoke size in a subprocess (two tenants through
     n_layers + 1 weight slots, virtual clock, trace and metrics files
     checked, one pulse_count launch per residency pair cost);
  9. the wear, fault and telemetry planes at gemma-7b's full width: phase
     6's two tenants and requests on the paged layout, every request
     submitted up front, behind an arena of n_layers + 2 slots with
     instant installs, in two arms on one schedule, stepped in turns: (A)
     every knob off; (B) wear-aware placement, seeded stuck-at faults (a
     plan that retires >= 1 weight slot and >= 2 KV pages, checked before
     the run), ITL and TTFT SLOs, events JSONL, a 64-step flight
     recorder, the step watchdog at 2 s, the wear map and Prometheus text
     into build/phase9, and the /metrics endpoint read once over
     localhost; B's greedy tokens must equal A's for every request, its
     exporters validate, a first switch's pair accounting must leave a
     stall_suspected dump, paged, flash and pulse_count (no other kernel)
     launch in each arm, the decode-only step walls of the two arms
     are compared step by step and 12 steps of each run under cProfile,
     and one of B's decode calls over retired-page tables is held against
     the plain version; then (C) wear-aware placement alone, for the
     blend's share of the weight Gini;
 10. the other families at full width: deepseek-v2-lite-16b (MLA + MoE,
     all 27 layers, weights drawn on the card) serves phase 3's requests
     through the engine three times, slot (the default), paged (page 16)
     and paged with chunks of 256 under a 512-token budget: every request
     finishes inside the vocab, 27 flash launches a monolithic prefill, 0
     chunked, 0 paged launches (MLA decodes with no kernel), the paged
     run's tokens and first decode step's MLA attention outputs equal the
     slot run's (the absorbed decode in f64: slot and paged reduce over
     552 and 4,480 positions), and a chunked first token
     that parts from them a near-tie the two routes' logits explain; the
     longest prompt's prefill logits against the plain versions within
     LOGIT_TOL with the MoE routing pinned to the kernel run's experts
     (printed unpinned too: routing is discontinuous); a decode step
     profiled, with the weight reads as written and as the step's
     routing hit them, and the MoE layers' share of its device time; then
     the longest prompt's prefill and a slot decode step under a 1 x 1
     mesh on a one-rank NCCL group (`moe_mesh`: the MoE layers on the
     reference's all-to-all and replicated bodies, 27 flash launches),
     each MoE layer's mesh output against the no-mesh one on its captured
     input, the dispatch against the CPU's, tokens dropped, expert rows,
     the MoE layers' device time with and without the mesh, and
     `compressed_psum_pod` against the CPU path, the group ended after.
     Then the default mode (phase 8's, every step against the plain
     versions, the routing pinned on the MoE model) on minicpm-2b at
     full depth and qwen3-32b, yi-34b and qwen3-moe-235b-a22b at full
     width and 8, 8 and 2 layers, each freed before the next;
 11. the recurrent families at full width: hymba-1.5b (all 32 layers, SWA
     or global attention beside Mamba in every block, weights drawn on the
     card) serves phase 3's requests and one prompt of 1,536 tokens
     through the slot engine (8 rows of 2,048): every request inside the
     vocab, 3 flash launches a prefill and 3 paged launches a decode batch
     (the global layers; the SWA layers take the masked softmax, banded
     past 1,024 tokens), every kernel call of the long prompt's prefill
     and one decode step within KERNEL_TOL of its plain version on its
     inputs, and their logits against the plain versions' within the
     larger of LOGIT_TOL and twice the noise floor the run measures (the
     plain versions moved by one ulp where kernel and plain part), the
     paged arena's refusal word for word, the default mode (every step
     against the plain versions), a decode step profiled with the Mamba
     branches' share and the long prompt's prefill wall with the time
     inside Mamba's scan;
     then xlstm-350m (all 24 layers) through the default mode and the slot
     engine with no kernel launched, and the engine's refusal of chunked
     prefill for its mLSTM layers;
 12. the two non-token input modes at full width: hubert-xlarge (an
     encoder over frame embeddings, all 48 layers) runs its forward over
     `make_batch`'s 4 x 1,500 frames: 48 non-causal flash launches (head
     dim 80 zero-padded to 128), no paged, finite logits within the
     larger of LOGIT_TOL and twice the measured noise floor of the plain
     versions', the forward profiled, and the flash kernel timed at that
     shape beside SDPA and its bound; then paligemma-3b (all 18 layers,
     MQA with head dim 256, 256 image-prefix positions) through the
     default mode at batch 4 x 32 text tokens, 16 new (prefill S 288 with
     the prefix mask, no flash; 18 paged launches a decode step over each
     304-token slot), every step against the plain versions, one B 1
     prefill of 1,024 text tokens (S 1,280: `chunked_attention` with the
     prefix term in every layer, its first call held against the masked
     softmax), and the paged kernel timed cold at the slot's shape;
 13. the ARAS paper layer: the paper's five nets (vgg16, resnet50,
     densenet161, bert_base, bert_large) with their seeded codes at
     1,000,000 samples a layer drawn onto the card, each through
     `simulate_aras` in the five variants (naive, baseline, B, BR, BRW),
     `simulate_tpu`, `upper_bound_cycles` and the BRW `build_schedule`,
     which must validate; every result must equal the same calls with the
     codes on the CPU, and each net's BRW/baseline speedup and §V-C center
     the reference's (model outputs of the paper's simulated machines);
     then the pulse_count kernel on every consecutive layer pair of
     resnet50 and bert_large (offsets of BRW, 53 + 144 launches), equal to
     its plain version and within 6 standard errors of the simulator's
     expected pulses per weight; then the three example arms
     (`examples/*_torch.py`) in this process, serve_stream_torch launching
     paged, flash, delta_apply and pulse_count;
 14. training at minicpm-2b's full width (40 layers, vocab 122,753, tied
     embeddings, WSD schedule, seeded random weights in the reference
     trainer's dtypes): the training attention Function at B 4 x S 2,048
     x H 36 x D 64 (the flash kernel's forward with its lse, the torch-op
     FA-2 backward) against autograd through the plain version, with its
     backward timed beside SDPA's forward + backward; three steps of
     `python -m repro_torch.launch.train --batch 4 --seq 2048` in this
     process (loss near ln V, gnorm finite, lr the WSD schedule's, 80
     flash launches a step: the forward and its remat recompute, nothing
     else launched; step walls, tokens/s, peak memory); make_train_step
     three times on one batch (the loss falls; the last step profiled);
     one step's loss and gradient through the kernels against the plain
     versions (every leaf within 3e-2); one step through the dense split
     path under a one-rank NCCL debug mesh (params and moments placed in
     the rank's blocks, every collective over one-rank groups) against the
     no-mesh step, arms in turns (loss, ce and grad norm within F32_TOL,
     80 flash launches, walls and peak memory); and the trainer at smoke
     size checkpointing and resuming on the card, the resumed lines equal
     to an uninterrupted run's;
 15. the dry run and the roofline (`repro_torch.launch.dryrun`): three cells
     counted on `meta` tensors under a fake 512-rank process group in this
     process: gemma-7b's and minicpm-2b's train_4k on the (16, 16) mesh as
     rank 0's split step with their rooflines (per-device FLOPs, bytes and
     collective bytes by kind and by mesh axis, the three terms and the
     dominant one, beside PR 32's whole step over the chips), and
     deepseek-v2-lite-16b's decode_32k on the (2, 16, 16) mesh as a
     sharding-proof run (per-device GB, fits), no process group left after
     any and no kernel launched; the roofline's HBM size against the card's; then one
     minicpm-2b training step at phase 14's B 4 x S 2,048 counted by the
     same code on `meta` and on the card (the flash kernel launched 80
     times, its tally by the formula of its `meta` route): FLOPs and bytes
     equal to COUNT_TOL, and the step's measured wall at or above the
     roofline bound of one card (the larger of FLOPs over the bf16 peak
     and bytes over the HBM rate), its share of the bound printed beside
     the card's name and power limit;
 16. print the `kernels` JSON line, then the result line.

The script imports nothing of JAX or of the JAX package.  Exits non-zero
without a result when no CUDA device is visible.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
CORE_OPS_PER_S = 67e12         # H100 SXM f32 rate outside the tensor cores,
                               # the bound taken for integer work on CUDA cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 tensor-core peak
LAYER_CODES = 276_824_064      # quantized weights of one gemma-7b layer
KERNEL_TOL = 2e-2              # bf16 output: the reference's own tolerance
F32_TOL = 3e-4                 # f32 output: the reference's own tolerance
BF16_TOL = 2e-2                # a norm of bf16 gradients
# f32 flash runs in split TF32 (three products per fragment), within ~4e-6
# of full f32; one TF32 pass is ~1.6e-3 off at S 512 D 256.  So its checks
# hold it ten times tighter than F32_TOL, where one pass fails.
FLASH_F32_TOL = 3e-5
# the flash kernels' lse (natural-log units) against the plain logsumexp:
# both sum exact products of the same inputs in f32, in other orders, and
# the kernels take exp2/log2 of the log2-scaled scores
LSE_TOL = 1e-4
# Logits after 28 bf16 layers: kernel and plain version round each layer's
# attention output at different points (online vs two-pass softmax, f32 sums
# in another order), which moves a few elements by one bf16 ulp (2**-8
# relative) per layer; random-weight layers amplify such differences, and
# the first chip run measured ~2% of the logit scale.  5% of the largest
# logit bounds that noise while a wrong kernel (a missed page, a wrong
# mask) moves logits by their own scale.
LOGIT_TOL = 0.05
SLEEP_CYCLES = 100_000_000     # ~50 ms of device sleep at the H100's clocks
REPEATS = 20                   # runs of a pipelined kernel held bit-identical
DELTA_ROUNDS = 3               # in-turn rounds of delta_apply and torch.add
L2_FLUSH_BYTES = 256 << 20     # read between cold timed calls: 5x the L2
# paged decode, timed: gemma-7b's heads over a 1,024-token table
# (PAGED_MAIN), a GQA shape, qwen3-32b's, qwen3-moe-235b-a22b's, yi-34b's
# and minicpm-2b's full-width decode heads, rows long enough that the
# split is what feeds the SMs, the serve run's table (34 pages, rows
# at 40-543 tokens) and hymba-1.5b's global layers over phase 11's slot
# rows (2,048 tokens seen as 128 pages of 16, one row past the long prompt)
PAGED_MAIN = "B8 Hkv16 G1 D256 page16 T64"
PAGED_TIMED = {
    PAGED_MAIN: dict(B=8, H=16, Hkv=16, D=256, page=16, T=64, seed=1),
    "B8 Hkv4 G4 D128 page16 T64": dict(B=8, H=16, Hkv=4, D=128, page=16,
                                       T=64, seed=2),
    "qwen3-32b B8 H64 Hkv8 G8 D128 page16 T64": dict(
        B=8, H=64, Hkv=8, D=128, page=16, T=64, seed=6),
    "qwen3-moe-235b B8 H64 Hkv4 G16 D128 page16 T64": dict(
        B=8, H=64, Hkv=4, D=128, page=16, T=64, seed=7),
    "yi-34b B8 H56 Hkv8 G7 D128 page16 T64": dict(
        B=8, H=56, Hkv=8, D=128, page=16, T=64, seed=13),
    "minicpm-2b B8 H36 Hkv36 G1 D64 page16 T64": dict(
        B=8, H=36, Hkv=36, D=64, page=16, T=64, seed=14),
    "long rows B2 Hkv16 G1 D256 page16 T512 (8,192 tokens each)": dict(
        B=2, H=16, Hkv=16, D=256, page=16, T=512, seed=8,
        pos_list=[8191, 8191]),
    "gemma-7b serve-like B8 Hkv16 G1 D256 page16 T34": dict(
        B=8, H=16, Hkv=16, D=256, page=16, T=34, seed=9,
        pos_list=[40, 120, 200, 290, 370, 450, 520, 543]),
    "hymba-1.5b B8 H25 Hkv5 G5 D64 page16 T128": dict(
        B=8, H=25, Hkv=5, D=64, page=16, T=128, seed=15,
        pos_list=[40, 120, 250, 380, 450, 520, 540, 1551]),
}
# paged decode, untimed: head dims off the tensor cores' 16-column step and
# group sizes that are not powers of two, (D, (H, Hkv), page, T)
PAGED_UNTIMED = [(D, heads, 8, 20)
                 for D in (8, 16, 24, 80)
                 for heads in ((4, 4), (25, 5), (56, 8), (32, 2))] + [
    (80, (16, 16), 16, 64), (256, (16, 16), 8, 9), (128, (64, 4), 4, 300)]
# paged decode, untimed: phase 8's page views of contiguous caches — the
# default mode's (4 rows of 544 tokens, 64 (row, KV head) pairs, one
# position for every row, first and last of its loop) and the slot
# engine's (8 slots of 552 tokens as 69 pages of 8)
PAGED_PATH_SHAPES = {
    "default mode B4 Hkv16 G1 D256 page16 T34 pos 512": dict(
        B=4, H=16, Hkv=16, D=256, page=16, T=34, seed=10,
        pos_list=[512] * 4),
    "default mode B4 Hkv16 G1 D256 page16 T34 pos 542": dict(
        B=4, H=16, Hkv=16, D=256, page=16, T=34, seed=11,
        pos_list=[542] * 4),
    "slot B8 Hkv16 G1 D256 page8 T69": dict(
        B=8, H=16, Hkv=16, D=256, page=8, T=69, seed=12,
        pos_list=[32, 100, 200, 290, 370, 450, 520, 551]),
}
# paged decode, untimed: tables so long and grids so wide (320 (row, KV
# head) pairs) that each row is one split whose page ids slide through
# the kernel's shared-memory window, a page of 1 and one of 12 (not a
# divisor of the 32-token tile)
PAGED_LONG_TABLES = [(8, (40, 40), 1, 3000), (16, (80, 40), 12, 700)]
# paged decode in f32, timed: the serve run's table (reported), G 4 and
# qwen3-moe-235b's G 16
PAGED_F32_MAIN = "gemma-7b serve-like B8 Hkv16 G1 D256 page16 T34"
PAGED_F32_TIMED = (PAGED_F32_MAIN, "B8 Hkv4 G4 D128 page16 T64",
                   "qwen3-moe-235b B8 H64 Hkv4 G16 D128 page16 T64")


def f32_fields(errs, checked, library_ms):
    """The f32 kernel's entries of a `kernels` line record: its largest
    error over every f32 check, and the timed check's time, plain version's
    time, bound and library call's time."""
    _, ms, plain_ms, _, (b, by) = checked[:5]
    return {"f32_max_abs_err": max(errs), "f32_ms": ms,
            "f32_plain_ms": plain_ms, "f32_bound_ms": b, "f32_bound_by": by,
            "f32_library_ms": library_ms}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn` in ms over `iters` calls after a warm-up,
    by CUDA events around the whole run.  The calls are queued behind a
    device-side sleep, so a kernel shorter than its host launch path is
    timed on the card and not at the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cold(fn, iters: int) -> float:
    """Mean device time of `fn` in ms over `iters` calls, each made after a
    read of L2_FLUSH_BYTES, so the call finds the 50 MB L2 holding none of
    its inputs, as a decode step finds the KV pools after the projections;
    timed by CUDA events around each call alone, queued behind a device
    sleep."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def kernel_wrappers():
    """{kernel: its wrapper}; each wrapper counts its launches in
    `.launches`."""
    from repro_torch.kernels.crossbar_mvm.ops import crossbar_mvm
    from repro_torch.kernels.delta_apply.ops import apply_delta
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.pulse_count.ops import pulse_count
    return {"paged_attention": paged_attention,
            "flash_attention": flash_attention, "delta_apply": apply_delta,
            "pulse_count": pulse_count, "crossbar_mvm": crossbar_mvm}


def zero_launch_counts() -> None:
    """Set the launch count of every kernel wrapper to 0: done just before
    each path is driven, so each path's counts are its own."""
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def launch_counts():
    """{kernel: launches} of every wrapper since the counts were zeroed."""
    return {name: w.launches for name, w in kernel_wrappers().items()}


def bound_ms(n_bytes: float, n_flops: float,
             ops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


TENSOR_CORE_SASS = ("HGMMA", "IGMMA", "HMMA", "IMMA")


def tensor_core_counts(build):
    """Tensor-core instructions in each built library, by SASS opcode
    (`cuobjdump -sass`): HGMMA/IGMMA are wgmma, HMMA/IMMA mma.sync."""
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME
    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "",
                                                     "bin", "cuobjdump")
    counts = {}
    for name in build.NAMES:
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\.", sass))
                        for op in TENSOR_CORE_SASS}
    return counts


# ------------------------------------------------------------ phase 2
def paged_inputs(torch, B, H, Hkv, D, page, T, seed, pos_list=None,
                 dtype=None, skip=()):
    """Random q and pools (bf16 unless `dtype`), a random page table and
    per-row positions; every pool position past a row's pos — inside its
    live page and in its later pages — holds 1e4 garbage.  The default
    positions start a row at 0, end rows exactly on a page boundary and
    one token past one, and end the last rows at the table's last
    tokens.  No table names page 0 or a page id in `skip` (retired
    pages): the pool holds them, with garbage."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * T + 1 + len(skip)
    dtype = dtype or torch.bfloat16
    q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(P, page, Hkv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(P, page, Hkv, D, generator=g, device=dev).to(dtype)
    keep = torch.tensor([i for i in range(1, P) if i not in skip],
                        device=dev)
    tables = keep[torch.randperm(P - 1 - len(skip), generator=g,
                                 device=dev)[:B * T]].view(B, T).to(
                                     torch.int32)
    for i in (0, *skip):
        k[i] = 1e4
        v[i] = 1e4
    cap = T * page
    if pos_list is None:
        pos_list = [0, page - 1, page, 3 * page + 5, cap // 2 + 7,
                    cap - page, cap - 2, cap - 1][:B]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    for b, p in enumerate(pos_list):       # stale garbage past each pos
        pages = tables[b].long()
        flat_k = k[pages].view(cap, Hkv, D)
        flat_v = v[pages].view(cap, Hkv, D)
        flat_k[p + 1:] = 1e4
        flat_v[p + 1:] = 1e4
        k[pages] = flat_k.view(T, page, Hkv, D)
        v[pages] = flat_v.view(T, page, Hkv, D)
    return q, k, v, tables, pos, pos_list


def check_split_plan(torch, library="paged_attention"):
    """A kernel library's split plan (bf16 "paged_attention" or
    "paged_attention_f32"), on this card's SM count: at most 32 splits
    that cover the table, chunks of whole 32-token tiles where the page
    size allows, scratch sized to the splits; returns the plans of
    PAGED_LONG_TABLES."""
    from repro_torch.kernels.paged_attention.ops import split_plan
    dev = torch.device("cuda", 0)
    for T, page in ((1, 16), (6, 4), (34, 16), (64, 16), (300, 4),
                    (512, 16), (700, 12), (100_000, 1)):
        for rows in (1, 32, 128, 320, 4096):
            n, chunk, n_part, n_ml, n_tick = split_plan(T, page, rows, 8,
                                                        128, dev, library)
            ok = (1 <= n <= 32 and (n - 1) * chunk < T <= n * chunk
                  and (chunk == T or 32 % page or chunk * page % 32 == 0)
                  and (n_part, n_ml, n_tick) == (
                      (rows * n * 8 * 128, rows * n * 32, rows) if n > 1
                      else (0, 0, 0)))
            if not ok:
                raise AssertionError(f"{library} split plan T={T} "
                                     f"page={page} rows={rows}: {n} x "
                                     f"{chunk} pages, scratch {n_part}, "
                                     f"{n_ml}, {n_tick}")
    return {(page, T): split_plan(T, page, 8 * Hkv, H // Hkv, D, dev,
                                  library)[:2]
            for D, (H, Hkv), page, T in PAGED_LONG_TABLES}


def check_paged(torch, B, H, Hkv, D, page, T, seed, pos_list=None,
                timed=True, dtype=None, skip=()):
    """Kernel vs plain within KERNEL_TOL (F32_TOL for f32 inputs, the plain
    version's products in full f32) on stale-garbage pools, and the
    kernel's output identical over repeats; when `timed`, the kernel's, the
    plain version's and the pre-gathered SDPA yardstick's times and the
    bound."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    dev = torch.device("cuda")
    q, k, v, tables, pos, pos_list = paged_inputs(torch, B, H, Hkv, D, page,
                                                  T, seed, pos_list, dtype,
                                                  skip)
    tol = F32_TOL if q.dtype == torch.float32 else KERNEL_TOL
    ref = paged_attention_plain(q, k, v, tables, pos)
    out = paged_attention(q, k, v, tables, pos)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= tol and torch.isfinite(out).all()
            and out.dtype == q.dtype):
        raise AssertionError(
            f"paged_attention kernel disagrees at B={B} H={H} Hkv={Hkv} "
            f"D={D} page={page} T={T} {q.dtype}: max abs err {err} > {tol}")
    # the splits' merge order is fixed: a race on the tickets would show as
    # runs that differ
    if not all(torch.equal(paged_attention(q, k, v, tables, pos), out)
               for _ in range(3)):
        raise AssertionError(f"paged_attention output changes between runs "
                             f"at B={B} H={H} Hkv={Hkv} D={D}")
    if not timed:
        return err, None, None, None, (None, None), None
    # cold, as the decode step calls it; back to back (warm), as this
    # script timed it before, when part of the pools stays in L2 between
    # calls
    ms = cuda_ms_cold(lambda: paged_attention(q, k, v, tables, pos), 50)
    warm_ms = cuda_ms(lambda: paged_attention(q, k, v, tables, pos), 50)
    plain_ms = cuda_ms(lambda: paged_attention_plain(q, k, v, tables, pos), 5)
    # no single PyTorch call pages; as a yardstick only, SDPA over K/V
    # already gathered into rows (the gather itself not timed)
    cap = T * page
    kg, vg = (x[tables.long()].view(B, cap, Hkv, D).transpose(1, 2)
              for x in (k, v))
    mask = (torch.arange(cap, device=dev)[None, :]
            <= pos[:, None]).view(B, 1, 1, cap)
    sdpa_ms = cuda_ms_cold(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q.view(B, H, 1, D), kg, vg, attn_mask=mask, enable_gqa=H != Hkv),
        50)
    live = sum(min(p + 1, cap) for p in pos_list)
    live_pages = sum(min(p // page + 1, T) for p in pos_list)
    size = q.element_size()
    n_bytes = (2 * B * H * D * size + 2 * live * Hkv * D * size
               + live_pages * 4 + B * 4)
    n_flops = 4 * live * H * D
    rate = CORE_OPS_PER_S if q.dtype == torch.float32 else BF16_FLOPS_PER_S
    return (err, ms, plain_ms, sdpa_ms, bound_ms(n_bytes, n_flops, rate),
            warm_ms)


def check_flash(torch, S, H, D, seed, Hkv=None, B=1, causal=True,
                timed=True, dtype=None):
    """Kernel vs plain within KERNEL_TOL (FLASH_F32_TOL for f32 inputs, the
    plain version's products in full f32); when `timed`, also the kernel's
    output identical over REPEATS runs, and the kernel's, the plain
    version's and SDPA's times and the bound.  For timed f32 inputs also a
    dict: the error of the plain version in one TF32 pass (which must miss
    FLASH_F32_TOL) and the bound on the CUDA cores beside the 3xTF32 one
    returned (three TF32 passes of the tensor cores)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    Hkv = Hkv or H
    dtype = dtype or torch.bfloat16
    tol = FLASH_F32_TOL if dtype == torch.float32 else KERNEL_TOL
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    if flash_attention.launches != before + 1:   # padded widths included
        raise AssertionError(f"flash_attention at D={D} counted "
                             f"{flash_attention.launches - before} launches "
                             f"for one call")
    ref = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= tol and torch.isfinite(out).all()
            and out.dtype == dtype):
        raise AssertionError(f"flash_attention kernel disagrees at B={B} "
                             f"S={S} H={H} Hkv={Hkv} D={D} causal={causal} "
                             f"{dtype}: max abs err {err} > {tol}")
    if not timed:
        return err, None, None, None, (None, None)
    # the kernel's stages pass between two warpgroups through mbarriers: a
    # race there would show as runs that differ
    if not all(torch.equal(flash_attention(q, k, v, causal=causal), out)
               for _ in range(REPEATS)):
        raise AssertionError(f"flash_attention output changes between runs "
                             f"at B={B} S={S} D={D}")
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal), 20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal),
                       5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=H != Hkv), 20)
    n_bytes = 2 * B * S * (H + Hkv) * D * q.element_size()
    pairs = S * (S + 1) // 2 if causal else S * S
    n_flops = 4 * B * D * H * pairs
    if dtype != torch.float32:
        return (err, ms, plain_ms, lib_ms,
                bound_ms(n_bytes, n_flops, BF16_FLOPS_PER_S))
    # the limit discriminates: the plain version with its products in one
    # TF32 pass misses it on these inputs
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = flash_attention_plain(q, k, v, causal=causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    one_pass_err = (one_pass - ref).abs().max().item()
    if not one_pass_err > FLASH_F32_TOL:
        raise AssertionError(f"one TF32 pass at S={S} D={D} is within "
                             f"{FLASH_F32_TOL} ({one_pass_err}): the f32 "
                             f"flash limit does not discriminate")
    return (err, ms, plain_ms, lib_ms,
            bound_ms(n_bytes, n_flops, TF32_FLOPS_PER_S / 3),
            {"one_pass_tf32_err": one_pass_err,
             "cuda_core_bound": bound_ms(n_bytes, n_flops, CORE_OPS_PER_S)})


def check_flash_lse(torch, S, H, D, seed, Hkv=None, B=1, causal=True,
                    dtype=None):
    """The kernels' lse mode (the training forward) against the plain
    version: `o` with lse bit for bit the `o` of the serving launch, and
    within the check_flash tolerance of the plain `o`; lse (B, H, S) f32
    within LSE_TOL of the plain logsumexp.  Returns (o err, lse err)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    Hkv = Hkv or H
    dtype = dtype or torch.bfloat16
    tol = FLASH_F32_TOL if dtype == torch.float32 else KERNEL_TOL
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    served = flash_attention(q, k, v, causal=causal)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if not (torch.equal(out, served) and lse.shape == (B, H, S)
            and lse.dtype == torch.float32 and torch.isfinite(lse).all()
            and err <= tol and lse_err <= LSE_TOL):
        raise AssertionError(f"flash_attention lse mode at B={B} S={S} H={H} "
                             f"Hkv={Hkv} D={D} causal={causal} {dtype}: o "
                             f"err {err}, lse err {lse_err}, o equal to the "
                             f"serving launch's: {torch.equal(out, served)}")
    return err, lse_err


def _codes(torch, n, gen, dev):
    return torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                         generator=gen)


def check_delta_apply(torch, n, seed):
    """Kernel vs plain, exactly: out of place, and in place on the delta
    (as an install turns the delta it received into the new codes)."""
    from repro_torch.kernels.delta_apply.ops import apply_delta
    from repro_torch.kernels.delta_apply.ref import delta_apply_plain
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    old, delta = _codes(torch, n, g, dev), _codes(torch, n, g, dev)
    ref = delta_apply_plain(old, delta)
    out = apply_delta(old, delta)
    landed = delta.clone()
    apply_delta(old, landed, out=landed)
    torch.cuda.synchronize()
    err = max((t.to(torch.int16) - ref.to(torch.int16)).abs().max().item()
              for t in (out, landed))
    if err != 0:
        raise AssertionError(f"delta_apply kernel disagrees at n={n}: max "
                             f"abs err {err}")
    # in place, as an install applies it, and out of place beside torch.add
    # in turns, DELTA_ROUNDS rounds of (kernel, library, library, kernel,
    # kernel in place); each time is the median of its runs
    fns = {"in place": lambda: apply_delta(old, out, out=out),
           "out of place": lambda: apply_delta(old, delta, out=out),
           "torch.add": lambda: torch.add(old, delta, out=out)}  # wraps
    runs = {k: [] for k in fns}
    for _ in range(DELTA_ROUNDS):
        for k in ("out of place", "torch.add", "torch.add", "out of place",
                  "in place"):
            runs[k].append(cuda_ms(fns[k], 20))
    med = {k: statistics.median(v) for k, v in runs.items()}
    plain_ms = cuda_ms(lambda: delta_apply_plain(old, delta), 3)
    return (err, med["in place"], plain_ms, med["torch.add"],
            bound_ms(3 * n, n, CORE_OPS_PER_S), med["out of place"], runs)


def check_pulse_count(torch, n, seed):
    """Kernel vs plain (pulses, unchanged cells), exactly, aligned and one
    byte off alignment."""
    from repro_torch.kernels.pulse_count.ops import pulse_count
    from repro_torch.kernels.pulse_count.ref import pulse_count_plain
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    old, new = _codes(torch, n, g, dev), _codes(torch, n, g, dev)
    new[: n // 3] = old[: n // 3]          # a third of the codes unchanged
    err = 0
    for a, b in ((old, new), (old[1:], new[1:])):
        got = [int(t) for t in pulse_count(a, b)]
        want = [int(t) for t in pulse_count_plain(a, b)]
        err = max(err, max(abs(x - y) for x, y in zip(got, want)))
    if err != 0:
        raise AssertionError(f"pulse_count kernel disagrees at n={n}: "
                             f"{got} vs plain {want}")
    ms = cuda_ms(lambda: pulse_count(old, new), 20)
    plain_ms = cuda_ms(lambda: pulse_count_plain(old, new), 3)
    # 2 bytes read per code; per cell a |Δ| accumulate and an equality count
    return err, got, ms, plain_ms, bound_ms(2 * n, 8 * n, CORE_OPS_PER_S)


def crossbar_equal(torch, out, ref, what):
    """crossbar_mvm's output against its plain version, exactly: the
    integer product and the row and column sums are exact, and the Eq. 7
    epilogue rounds every f32 operation to nearest in the plain version's
    order, so any difference is a fault.  (The reference's rtol 1e-5,
    atol 1e-2 would pass a wrong kernel at gemma-7b's outputs of ~0.02.)
    Returns the max abs error."""
    err = (out - ref).abs().max().item()
    if not (torch.isfinite(out).all() and torch.equal(out, ref)):
        raise AssertionError(f"crossbar_mvm kernel disagrees {what}: max "
                             f"abs err {err} at outputs up to "
                             f"{ref.abs().max().item()}")
    return err


def check_crossbar(torch, x, w, zpx, zpw, scale):
    """Kernel vs plain, exactly; the library yardstick is `torch._int_mm`
    on the -128-shifted operands (the int8 product alone, no correction)."""
    from repro_torch.kernels.crossbar_mvm.ops import crossbar_mvm
    from repro_torch.kernels.crossbar_mvm.ref import crossbar_mvm_plain
    (M, K), N = x.shape, w.shape[1]
    out = crossbar_mvm(x, w, zpx, zpw, scale)
    ref = crossbar_mvm_plain(x, w, zpx, zpw, scale)
    torch.cuda.synchronize()
    err = crossbar_equal(torch, out, ref, f"at {(M, K, N)}")
    ms = cuda_ms(lambda: crossbar_mvm(x, w, zpx, zpw, scale), 5)
    plain_ms = cuda_ms(lambda: crossbar_mvm_plain(x, w, zpx, zpw, scale), 2)
    lib_ms = None
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        xs = (x.to(torch.int16) - 128).to(torch.int8)
        ws = (w.to(torch.int16) - 128).to(torch.int8).t().contiguous().t()
        lib_ms = cuda_ms(lambda: torch._int_mm(xs, ws), 5)
    n_bytes = M * K + K * N + 4 * M * N
    return err, ms, plain_ms, lib_ms, bound_ms(n_bytes, 2 * M * N * K,
                                               INT8_OPS_PER_S)


def kernel_split(torch, fn, calls=3):
    """Device time per call of each kernel `fn` launches, by the profiler:
    [(ms, kernel name)], largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.device_time_total / 1e3 / calls, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)


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
                     kv_layout="paged", page_size=page, n_pages=n_pages)],
        sched=SchedulerConfig(max_prefill_per_step=4), device="cuda")
    for prompt, n_new, sampling in requests:
        eng.submit("gemma-7b", prompt, max_new_tokens=n_new, **sampling)
    # the tenant's weights go into its arena (cold installs, accounted) as
    # they are loaded: set-up, outside the timed run
    eng.residency.ensure("gemma-7b", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
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
    tokens = {r.rid: list(r.generated) for r in reqs}
    del eng
    return launches, tokens


# ------------------------------------------------------------ phase 4
def plain_attention():
    """A patch that swaps both attention wrappers for their plain
    versions, on the card."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    from repro_torch.nn import attention as attn_mod
    return mock.patch.multiple(
        attn_mod, paged_attention=lambda *a: paged_attention_plain(*a),
        flash_attention=lambda q, k, v, causal: flash_attention_plain(
            q, k, v, causal))


def first_step_logits(torch, cfg, params, requests, page):
    """Prefill the prompts into a fresh arena, then run the first batched
    decode step twice on identical pools: through the kernels, and with
    both wrappers swapped for their plain versions.  Prefill logits are
    compared the same way."""
    from repro_torch.launch.steps import paged_serve_step, prefill_step
    from repro_torch.serving.paging import PagedKVArena
    from repro_torch.tree import tree_leaves
    plain = plain_attention()
    max_seq = max(len(p) + n for p, n, _ in requests)
    arena = PagedKVArena(cfg, 8, 8 * -(-max_seq // page), page,
                         device="cuda")
    pre_err = 0.0
    for rid, (prompt, _, _) in enumerate(requests[:8]):
        row = arena.alloc(rid, tuple(prompt))
        tokens = torch.tensor([prompt], device="cuda")
        bucket = arena.blocks_for(len(prompt)) * page
        logits, one = prefill_step(params, {"tokens": tokens}, cfg, bucket)
        with plain:
            logits_p, _ = prefill_step(params, {"tokens": tokens}, cfg, bucket)
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


def profile_step(torch, step, steps, label, bound_ms_,
                 bound_label="weight-read bound"):
    """Where one step's time goes: host wall time per step (ending in a
    synchronize) against the device time the profiler attributes to
    kernels, and the kernels that take it.  Returns the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    log(f"{label}: {wall_ms:.2f} ms wall, {device_ms:.2f} ms device "
        f"({device_ms / wall_ms:.1%} busy), "
        f"{sum(e.count for e in kernels) // steps} kernels and {n_ops} aten "
        f"calls per step; {bound_label} {bound_ms_:.2f} ms")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        log(f"  {e.device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{e.count // steps:5d}x  {e.key[:90]}")
    return wall_ms


def profile_decode(torch, cfg, params, arena, steps=5):
    """A batched decode step of the arena's 8 rows."""
    from repro_torch.launch.steps import paged_serve_step
    tok, pos, tables = arena.decode_inputs()
    return profile_step(
        torch, lambda: paged_serve_step(params, tok, arena.caches, pos,
                                        tables, cfg), steps,
        f"decode step (8 rows, {cfg.n_layers} layers)",
        cfg.param_count() * 2 / HBM_BYTES_PER_S * 1e3)


def profile_prefill(torch, cfg, params, prompt, steps=3):
    """The prefill step of one prompt, as the engine runs it."""
    from repro_torch.launch.steps import prefill_step
    tokens = torch.tensor([prompt], device="cuda")
    profile_step(torch, lambda: prefill_step(params, {"tokens": tokens}, cfg,
                                             len(prompt)), steps,
                 f"prefill step (1 x {len(prompt)} tokens, {cfg.n_layers} "
                 f"layers)", cfg.param_count() * 2 / HBM_BYTES_PER_S * 1e3)


# ------------------------------------------------------------ phase 5
def measure_h2d(torch, n_bytes):
    """Host-to-device copy rate from pinned memory (bytes/s) on a layer-
    sized copy, and the time of a 4 KB copy (the per-copy latency)."""
    src = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(n_bytes, dtype=torch.uint8, device="cuda")
    big = cuda_ms(lambda: dst.copy_(src, non_blocking=True), 5)
    small = cuda_ms(lambda: dst[:4096].copy_(src[:4096], non_blocking=True),
                    50)
    return n_bytes / (big / 1e3), small / 1e3


def _check_every_install(torch, ex):
    """Wrap `ex.install` so each install is followed by a check that the
    slot holds exactly the store's codes of the installed layer."""
    install = ex.install

    def checked(layer):
        install(layer)
        torch.cuda.synchronize()
        codes = ex.slots[ex.layer_slot[layer]][1]
        want = ex.store.layers[layer].codes.to(codes.device)
        if not torch.equal(codes, want):
            raise AssertionError(f"slot codes of layer {layer} differ from "
                                 f"the store's after install "
                                 f"{len(ex.install_log)}")
    ex.install = checked


def _device_busy_s(prof):
    """Union of the device intervals the profiler traced (kernels and
    copies on every stream), in seconds."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def streaming(torch, cfg, params, counters):
    """The ARAS streaming path at full width: build the executor's store,
    run the main path through the kernels (counted and profiled), then
    again with every install checked, then with the install kernels
    swapped for their plain versions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.delta_apply.ref import delta_apply_plain
    from repro_torch.kernels.pulse_count.ref import pulse_count_plain
    from repro_torch.streaming import delta as delta_mod
    from repro_torch.streaming import executor as exec_mod
    from repro_torch.streaming.plan import LinkModel
    dma_bw, dma_lat = measure_h2d(torch, LAYER_CODES)
    log(f"host-to-device from pinned memory: {dma_bw / 1e9:.2f} GB/s on a "
        f"{LAYER_CODES / 1e6:.1f} MB copy; a 4 KB copy takes "
        f"{dma_lat * 1e6:.2f} us")
    B, S, slots = 4, 512, 3
    t0 = time.perf_counter()
    ex = exec_mod.StreamingExecutor(
        params, cfg, arena_slots=slots, plan_tokens=B * S,
        link=LinkModel(dma_bw=dma_bw, dma_latency_s=dma_lat), device="cuda")
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    n_codes = ex.store.layers[0].codes.numel()
    log(f"store: {ex.n_layers} layers x {n_codes:,} codes quantized and "
        f"re-encoded on the card in {t_store:.2f} s (center "
        f"{ex.store.center}, offsets "
        f"{[lw.offset for lw in ex.store.layers]})")
    if n_codes != LAYER_CODES:
        raise AssertionError(f"a layer holds {n_codes} codes, want "
                             f"{LAYER_CODES}")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                       device="cuda")}

    # the main path: counts set to 0 just before, read just after
    zero_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        logits, m = ex.forward(batch)
    launches = {name: c.launches for name, c in counters.items()}
    installs = ex.install_log
    n_delta = sum(r["kind"] == "delta" for r in installs)
    want = {"delta_apply": n_delta, "pulse_count": len(installs),
            "flash_attention": cfg.n_layers}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"streaming launches {launches}, want {want}")
    if not (logits.shape == (B, S, cfg.vocab_padded)
            and torch.isfinite(logits[..., :cfg.vocab]).all()):
        raise AssertionError("streaming logits not finite / wrong shape")
    for r in installs:
        log(f"  install L{r['layer']:<2d} {r['kind']:5s} slot {r['slot']} "
            f"(was {r['resident']}): wire {r['wire_bytes']:,} B, skip "
            f"{r['skip']:.4f}, cells {r['cells']:,}, pulses {r['pulses']:,}, "
            f"host delta {r['host_s'] * 1e3:.1f} ms, accounting "
            f"{r['account_s'] * 1e3:.1f} ms, copy {r['copy_s'] * 1e3:.2f} ms")
    averages = prof.key_averages()
    dev_events = [e for e in averages if e.device_type == DeviceType.CUDA]
    copy_s = sum(e.device_time_total for e in dev_events
                 if "HtoD" in e.key) / 1e6
    kernel_s = sum(e.device_time_total for e in dev_events
                   if "Memcpy" not in e.key and "Memset" not in e.key) / 1e6
    busy = _device_busy_s(prof)
    host_s = sum(r["host_s"] for r in installs)
    account_s = sum(r["account_s"] for r in installs)
    # one layer's compute (dequantize + block) alone on the compute stream,
    # on a layer the arena still holds
    from repro_torch.nn.model import _inputs_to_x
    x0, _ = _inputs_to_x({"embedding": ex.embedding}, batch, cfg)
    layer_ms = cuda_ms(lambda: ex._compute(ex.slots[0][0], x0), 3)
    log(f"streaming forward B{B} S{S}, {slots} slots: {m['wall_s'] * 1e3:.1f} "
        f"ms wall (profiled); {len(installs)} installs ({n_delta} delta), "
        f"wire {m['wire_bytes'] / 1e6:.1f} MB vs raw "
        f"{m['raw_bytes'] / 1e6:.1f} MB, mean skip {m['mean_skip']:.4f}, "
        f"center {int(m['reuse_center'])}; plan overlap speedup "
        f"{m['plan_overlap_speedup']:.4f} (makespan "
        f"{m['plan_makespan_s'] * 1e3:.2f} ms vs serial "
        f"{m['plan_serial_s'] * 1e3:.2f} ms)")
    log(f"streaming time split: host delta {host_s * 1e3:.1f} ms, "
        f"accounting waited for {account_s * 1e3:.1f} ms; device: H2D "
        f"copies {copy_s * 1e3:.1f} ms, kernels {kernel_s * 1e3:.1f} ms "
        f"(one layer's compute alone {layer_ms:.3f} ms, x {cfg.n_layers} = "
        f"{layer_ms * cfg.n_layers:.1f} ms), busy {busy * 1e3:.1f} ms = "
        f"{busy / m['wall_s']:.1%} of wall (idle {1 - busy / m['wall_s']:.1%})")
    for e in sorted(dev_events, key=lambda e: -e.device_time_total)[:8]:
        log(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
            f"{e.key[:90]}")
    log(f"launches in the streaming run: {json.dumps(launches)}")
    flips = [(r["cells"], r["pulses"]) for r in installs]

    # the same forward, every install's slot checked against the store
    ex.reset()
    _check_every_install(torch, ex)
    t0 = time.perf_counter()
    again, _ = ex.forward(batch)
    log(f"streaming forward with every install checked: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    if not torch.equal(again, logits):
        raise AssertionError("streaming logits differ between two runs")

    # plain versions of the install kernels (flash stays the kernel, held
    # against its plain version in phases 2 and 4)
    ex.reset()
    plain = mock.patch.multiple(
        exec_mod, apply_delta=lambda old, d, out: out.copy_(
            delta_apply_plain(old, d)))
    with plain, mock.patch.object(delta_mod, "pulse_count",
                                  pulse_count_plain):
        plain_logits, _ = ex.forward(batch)
    plain_flips = [(r["cells"], r["pulses"]) for r in ex.install_log]
    if plain_flips != flips:
        raise AssertionError(f"pulse_count per install {flips} differ from "
                             f"the plain version's {plain_flips}")
    if not torch.equal(plain_logits, logits):
        raise AssertionError("streaming logits through the plain install "
                             "versions differ from the kernels'")
    del ex.install
    log(f"streaming kernels vs plain versions: logits identical, every "
        f"slot equal to the store after each of {len(installs)} installs, "
        f"pulses and unchanged cells identical on every install pair")
    return ex, batch, logits, launches


def crossbar_operands(torch, cfg, ex, batch):
    """Layer 0's w_gate and w_up codes (3072 x 24576) from the streaming
    store, and the batch's embeddings (2048 x 3072) quantized per tensor
    as the store quantizes: {name: (w codes, zp_w, s_x * s_w)}."""
    from repro_torch.nn.model import _inputs_to_x
    from repro_torch.streaming.delta import _quantize
    lw = ex.store.layers[0]
    names = [p for p, f in zip(ex.paths[0], ex.flags[0]) if f]
    x, _ = _inputs_to_x({"embedding": ex.embedding}, batch, cfg)
    x_codes, s_x, zp_x = _quantize(x.reshape(-1, cfg.d_model).float())
    mats = {path[1]: (lw.tensor(i).to("cuda"), lw.zero_points[i],
                      np.float32(s_x * lw.scales[i]))
            for i, path in enumerate(names)
            if path in (("mlp", "w_gate"), ("mlp", "w_up"))}
    return x_codes.view(-1, cfg.d_model), zp_x, mats


def crossbar_path(torch, x_codes, zp_x, mats, counter):
    """crossbar_mvm's own entry point: the int8 MLP input projections
    (gate and up) of the quantized activations, counted, then each output
    held exactly against the plain version."""
    from repro_torch.kernels.crossbar_mvm.ops import crossbar_mvm
    from repro_torch.kernels.crossbar_mvm.ref import crossbar_mvm_plain
    zero_launch_counts()
    outs = [crossbar_mvm(x_codes, w, zp_x, zp_w, sc)
            for w, zp_w, sc in mats.values()]
    torch.cuda.synchronize()
    launches = counter.launches
    if launches != len(mats):
        raise AssertionError(f"crossbar path: {launches} launches, want "
                             f"{len(mats)}")
    for (name, (w, zp_w, sc)), out in zip(mats.items(), outs):
        crossbar_equal(torch, out, crossbar_mvm_plain(x_codes, w, zp_x, zp_w,
                                                      sc), f"on {name}")
    log(f"crossbar path: activation codes {tuple(x_codes.shape)} x "
        f"{len(mats)} weight code matrices {tuple(outs[0].shape)}: "
        f"{launches} launches")
    return launches


# ------------------------------------------------------------ phase 6
TURN_STEPS = 8                 # --turn-steps, the reference CLI's default


def perturb_on_device(torch, params, scale=0.02, seed=1):
    """tenant-b: `perturbed_variant`'s formula — every leaf of >= 2 dims and
    >= 1024 elements plus N(0, (scale · std)²) noise rounded to its dtype,
    leaves in jax's order — with the normals drawn on the card from a
    torch.Generator(seed) instead of numpy's stream, which the host draws
    chunk by chunk; smaller leaves are shared."""
    from repro_torch.serving.variants import CHUNK, _std
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def walk(node):
        if isinstance(node, dict):
            done = {k: walk(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if node.ndim < 2 or node.numel() < 1024:
            return node
        factor = scale * _std(node)
        out = torch.empty_like(node)
        src, dst = node.reshape(-1), out.view(-1)
        for s in range(0, src.numel(), CHUNK):
            n = min(CHUNK, src.numel() - s)
            z = torch.randn(n, generator=gen, device="cuda").mul_(factor)
            torch.add(src[s:s + n], z.to(node.dtype), out=dst[s:s + n])
        return out

    return walk(params)


def two_tenant_requests(cfg):
    """Eight requests alternating between the tenants, as `--engine`
    submits them: prompts of 64-256 tokens, 24-32 new tokens each, so a
    tenant needs several turns and the arena switches both ways."""
    rng = np.random.default_rng(1)
    return [(("tenant-a", "tenant-b")[i % 2],
             rng.integers(1, cfg.vocab, int(rng.integers(64, 257))).tolist(),
             int(rng.integers(24, 33))) for i in range(8)]


def two_tenant_run(torch, cfg, tenants, slots, requests, **engine_kw):
    """Build the two-tenant engine (its store included, timed), then serve
    `requests` with the launch counts set to 0 just before; returns (engine,
    summary, tokens by request, build s, serve s, launches)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.pulse_count.ops import pulse_count
    from repro_torch.serving import EngineModel, SchedulerConfig, ServingEngine
    from repro_torch.serving import engine as engine_mod
    max_seq = max(len(p) + n for _, p, n in requests)
    t0 = time.perf_counter()
    eng = ServingEngine(
        [EngineModel(name, params, cfg, kv_slots=4, max_seq=max_seq,
                     kv_layout="paged", page_size=16)
         for name, params in tenants.items()],
        weight_arena_slots=slots,
        sched=SchedulerConfig(max_prefill_per_step=4,
                              model_turn_steps=TURN_STEPS),
        device="cuda", **engine_kw)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    instrumented = instrument_residency(torch, eng)
    for model, prompt, n_new in requests:
        eng.submit(model, prompt, max_new_tokens=n_new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode_step = engine_mod.fused_paged_serve_step
    decode_batches = []          # one per tenant decoded in a step

    def counted(*args):
        decode_batches.append(1)
        return decode_step(*args)

    zero_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(engine_mod, "fused_paged_serve_step", counted):
        summary = eng.run()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {"paged_attention": paged_attention.launches,
                "flash_attention": flash_attention.launches,
                "pulse_count": pulse_count.launches}
    reqs = list(eng.requests.values())
    if not all(r.status.value == "finished"
               and len(r.generated) == r.max_new_tokens
               and all(0 <= t < cfg.vocab for t in r.generated)
               for r in reqs):
        raise AssertionError("two tenants: not every request finished "
                             "inside the vocab: " + ", ".join(
                                 f"{r.rid}:{r.status.value}:"
                                 f"{len(r.generated)}" for r in reqs))
    prefills = sum(s.n_prefills for s in eng.metrics.steps)
    misses = instrumented[0]
    want = {"paged_attention": cfg.n_layers * len(decode_batches),
            "flash_attention": cfg.n_layers * prefills,
            "pulse_count": len(misses)}
    if launches != want or not all(launches.values()):
        raise AssertionError(f"two tenants, {slots} slots: launches "
                             f"{launches}, want {want}")
    tokens = {r.rid: list(r.generated) for r in reqs}
    return eng, summary, tokens, t_build, t_serve, launches, instrumented


def instrument_residency(torch, eng):
    """Time every pair cost the greedy computes (a memo miss) with its
    engine step: host wall (each ends in host syncs) and device span (CUDA
    events around it); and log every committed install as (occupant,
    layer, step)."""
    res = eng.residency
    misses, commits = [], []
    cost, install = res._cost, res._install

    def timed(occupant, layer):
        if (occupant, layer) in res._cost_cache:
            return cost(occupant, layer)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        got = cost(occupant, layer)
        end.record()
        end.synchronize()
        misses.append((occupant, layer, eng._step_no,
                       time.perf_counter() - t0,
                       start.elapsed_time(end) / 1e3))
        return got

    def logged(layer, slot, step):
        occupant = res.slots[slot]
        wire = install(layer, slot, step)
        if wire is not None:
            commits.append((occupant, layer, step))
        return wire

    res._cost, res._install = timed, logged
    return misses, commits


def recost_pairs(torch, res, pairs):
    """Recompute each pair's cost with the memo bypassed: through the
    pulse_count kernel, profiled (device busy time per pair), and with the
    kernel swapped for its plain version.  Both must equal the committed
    (memoised) cost: wire bytes, skip, cells and pulses."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.pulse_count.ref import pulse_count_plain
    from repro_torch.streaming import delta as delta_mod

    def fresh(key):
        saved = res._cost_cache.pop(key)
        try:
            return type(res)._cost(res, *key)
        finally:
            res._cost_cache[key] = saved

    type(res)._cost(res, *pairs[0])        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernel = [fresh(k) for k in pairs]
        torch.cuda.synchronize()
    with mock.patch.object(delta_mod, "pulse_count", pulse_count_plain):
        plain = [fresh(k) for k in pairs]
    committed = [res._cost_cache[k] for k in pairs]
    if not kernel == plain == committed:
        raise AssertionError(f"re-costed pairs {pairs}: kernel {kernel}, "
                             f"plain {plain}, committed {committed}")
    return committed, _device_busy_s(prof) / len(pairs)


def install_episodes(steps):
    """Lengths, in steps, of the runs of consecutive steps that carried
    install work."""
    runs, n = [], 0
    for s in steps:
        if s.install_work_bytes or s.install_wire_bytes:
            n += 1
        elif n:
            runs.append(n)
            n = 0
    return runs + ([n] if n else [])


def two_tenants(torch, cfg, base, decode_wall_ms):
    """Two gemma-7b tenants at full width, tenant-b a perturbation of
    tenant-a: first every layer resident (2 x n_layers slots, nothing
    switches), then through an arena of n_layers + 1 slots with reuse on
    and the install pipeline overlapped with decode (one tick per step, a
    tick the bytes one decode step's wall could move at the measured
    host-to-device rate).  The greedy tokens of the two runs must be
    equal, and three committed cross-tenant pairs must cost the same
    through the plain pulse_count."""
    from repro_torch.serving import InstallCostModel, format_summary
    t0 = time.perf_counter()
    variant = perturb_on_device(torch, base)
    torch.cuda.synchronize()
    log(f"tenant-b: perturbed_variant's formula (scale 0.02, seed 1) over "
        f"tenant-a's leaves, its normals drawn on the card from a "
        f"torch.Generator, not numpy's stream, in "
        f"{time.perf_counter() - t0:.1f} s")
    tenants = {"tenant-a": base, "tenant-b": variant}
    requests = two_tenant_requests(cfg)

    eng, summary, want, t_build, t_serve, _, _ = two_tenant_run(
        torch, cfg, tenants, 2 * cfg.n_layers, requests)
    log(f"two tenants, all resident ({2 * cfg.n_layers} slots): store of "
        f"{len(eng.residency.store.layers)} layers built in {t_build:.2f} s; "
        f"{int(summary['tokens_generated'])} tokens in {t_serve:.3f} s, "
        f"{int(summary['steps'])} steps, {int(summary['installs'])} "
        f"installs ({int(summary['cold_installs'])} cold)")
    # the instrumented residency and its engine form a cycle: collect it,
    # so this store's pinned host memory is free before the next is built
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    h2d, _ = measure_h2d(torch, LAYER_CODES)
    per_tick = int(h2d * decode_wall_ms / 1e3)
    log(f"install tick: {per_tick / 1e6:.1f} MB = host-to-device "
        f"{h2d / 1e9:.2f} GB/s (measured) x the decode step's "
        f"{decode_wall_ms:.2f} ms wall (phase 4), one tick per step")
    slots = cfg.n_layers + 1
    eng, summary, got, t_build, t_serve, launches, (misses, commits) = \
        two_tenant_run(torch, cfg, tenants, slots, requests,
                       install_ticks_per_step=1, overlap_installs=True,
                       install_cost=InstallCostModel(bytes_per_tick=per_tick))
    res = eng.residency
    peak = torch.cuda.max_memory_allocated() / 2**30
    if got != want:
        raise AssertionError("two tenants: tokens through the "
                             f"{slots}-slot arena differ from the all-"
                             f"resident run's: {got} vs {want}")
    cross = [(o, l, st) for o, l, st in commits
             if o is not None and res.model_of[o] != res.model_of[l]]
    directions = {(res.model_of[o], res.model_of[l]) for o, l, _ in cross}
    if directions != {("tenant-a", "tenant-b"), ("tenant-b", "tenant-a")}:
        raise AssertionError(f"two tenants: cross-tenant installs went "
                             f"{directions}, want both directions")
    log(format_summary(summary))
    tokens = int(summary["tokens_generated"])
    log(f"two tenants, {slots} slots, reuse on, overlapped pipeline: store "
        f"built in {t_build:.2f} s; {tokens} tokens in {t_serve:.3f} s = "
        f"{tokens / t_serve:.1f} tok/s, {int(summary['steps'])} steps; "
        f"peak memory {peak:.2f} GiB; launches {json.dumps(launches)}")
    log(f"residency: {int(summary['installs'])} installs "
        f"({int(summary['cold_installs'])} cold, "
        f"{int(summary['cross_tenant_installs'])} cross-tenant), raw "
        f"{summary['install_raw_bytes'] / 1e6:.1f} MB, wire "
        f"{summary['install_wire_bytes'] / 1e6:.1f} MB, savings "
        f"{summary['install_savings']:.4f}, mean skip "
        f"{summary['install_mean_skip']:.4f}, cell flips "
        f"{int(summary['install_cell_flips']):,}, write pulses "
        f"{int(summary['install_write_pulses']):,}; stall steps "
        f"{int(summary['install_stall_steps'])}, install work in "
        f"{sum(install_episodes(eng.metrics.steps))} steps (runs "
        f"{install_episodes(eng.metrics.steps)}), hidden "
        f"{summary['overlap_hidden_bytes'] / 1e6:.1f} of "
        f"{summary['install_work_bytes'] / 1e6:.1f} MB")
    kind = {}
    for occupant, layer, step, host_s, dev_s in misses:
        key = ("cold" if occupant is None else
               f"{res.model_of[occupant]}->{res.model_of[layer]}")
        n, h, d, at = kind.get(key, (0, 0.0, 0.0, {}))
        at[step] = at.get(step, 0) + 1
        kind[key] = (n + 1, h + host_s, d + dev_s, at)
    for key, (n, h, d, at) in sorted(kind.items()):
        log(f"accounting {key}: {n} pair costs (pulse_count launches), "
            f"host wall {h:.2f} s, device span {d:.2f} s; costs by step "
            f"{json.dumps(at)}")
    switch_steps = {}
    for o, l, st in cross:
        switch_steps.setdefault((res.model_of[o], res.model_of[l]),
                                []).append(st)
    log(f"cross-tenant installs by direction, steps: " + "; ".join(
        f"{a}->{b} {len(v)} in steps {v[0]}-{v[-1]}"
        for (a, b), v in sorted(switch_steps.items())))
    pairs = list(dict.fromkeys(c[:2] for c in cross))   # distinct, in order
    picks = [pairs[0], pairs[len(pairs) // 2], pairs[-1]]
    costs, busy = recost_pairs(torch, res, picks)
    log(f"re-costed pairs {picks} (store layers): kernel = plain = "
        f"committed {costs}; device busy {busy * 1e3:.2f} ms a pair "
        f"(profiled)")
    for key in ("tenant-a->tenant-b", "tenant-b->tenant-a"):
        first = min(kind[key][3])
        mine = [m for m in misses if m[2] == first and m[0] is not None
                and f"{res.model_of[m[0]]}->{res.model_of[m[1]]}" == key]
        log(f"first switch {key}: {len(mine)} pair costs in step {first}, "
            f"host wall {sum(m[3] for m in mine):.2f} s, device span "
            f"{sum(m[4] for m in mine):.2f} s, device busy "
            f"~{len(mine) * busy:.2f} s ({len(mine)} x the profiled pair)")
    del eng, res
    return launches


# ------------------------------------------------------------ phase 7
CHUNK = 256                    # --prefill-chunk of the chunked arm
CHUNK_BUDGET = 512             # --prefill-token-budget of the chunked arm
SHARED_PREFIX = 1024           # the prefix-cache arm's shared prompt head


def chunked_engine(torch, cfg, params, max_seq, n_pages, prefix_cache):
    """One tenant, 8 decode rows, page 16, chunks of CHUNK under a
    CHUNK_BUDGET-token step budget; its weights installed (set-up)."""
    from repro_torch.serving import (EngineModel, SchedulerConfig,
                                     ServingEngine)
    eng = ServingEngine(
        [EngineModel("gemma-7b", params, cfg, kv_slots=8, max_seq=max_seq,
                     kv_layout="paged", page_size=16, n_pages=n_pages,
                     prefix_cache=prefix_cache)],
        sched=SchedulerConfig(max_prefill_per_step=4,
                              prefill_token_budget=CHUNK_BUDGET),
        prefill_chunk=CHUNK, device="cuda")
    eng.residency.ensure("gemma-7b", 0)       # set-up, as in phase 3
    torch.cuda.synchronize()
    return eng


def run_chunked(torch, cfg, eng, submit):
    """Run `submit(eng, reqs)`, which submits into `reqs` and drives `eng`,
    with the launch counts set to 0 just before; every chunk step is timed
    on the host (synchronized at both ends).  Returns (requests, launches,
    chunks, decode batches, wall s) with chunks as (chunk_len,
    staging_len, start, n_valid, ms)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.serving import engine as engine_mod
    chunks = []
    cached = engine_mod.cached_chunk_prefill_step

    def timed(cfg_, chunk_len, staging_len):
        step = cached(cfg_, chunk_len, staging_len)

        def run(params, tokens, caches, start, n_valid):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, tokens, caches, start, n_valid)
            torch.cuda.synchronize()
            chunks.append((chunk_len, staging_len, start, n_valid,
                           (time.perf_counter() - t0) * 1e3))
            return out
        return run

    reqs = []
    zero_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(engine_mod, "cached_chunk_prefill_step", timed):
        submit(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": paged_attention.launches,
                "flash_attention": flash_attention.launches}
    if not all(r.status.value == "finished"
               and len(r.generated) == r.max_new_tokens
               and all(0 <= t < cfg.vocab for t in r.generated)
               for r in reqs):
        raise AssertionError("chunked: not every request finished inside "
                             "the vocab: " + ", ".join(
                                 f"{r.rid}:{r.status.value}:"
                                 f"{len(r.generated)}" for r in reqs))
    decode_batches = sum(1 for st in eng.metrics.steps if st.n_decoded)
    want = {"paged_attention": cfg.n_layers * decode_batches,
            "flash_attention": 0}
    if launches != want:
        raise AssertionError(f"chunked: launches {launches}, want {want}")
    return reqs, launches, chunks, decode_batches, wall


def log_chunks(label, chunks):
    """Every chunk as `chunk tokens`/`staging tokens`@start+valid: wall ms."""
    log(f"{label}: {len(chunks)} chunks: " + ", ".join(
        f"{c}/{s}@{start}+{n}: {ms:.2f} ms"
        for c, s, start, n, ms in chunks))


def chunk_logits_check(torch, cfg, params, prompt):
    """The longest prompt chunk by chunk through `chunk_prefill` into a
    staging cache against the monolithic `prefill` (the flash kernel):
    last-chunk logits within LOGIT_TOL of the logit scale, and the same
    greedy pick.  Then one chunk step is profiled."""
    from repro_torch.launch.steps import chunk_prefill_step, prefill_step
    from repro_torch.nn.model import init_cache
    from repro_torch.tree import tree_leaves
    tokens = torch.tensor([prompt], device="cuda")
    staging = -(-len(prompt) // CHUNK) * CHUNK
    caches = init_cache(cfg, 1, staging, staging=True, device="cuda")
    for start in range(0, len(prompt), CHUNK):
        n = min(CHUNK, len(prompt) - start)
        logits, caches = chunk_prefill_step(
            params, tokens[:, start:start + n], caches, start, n, cfg)
    mono, mono_cache = prefill_step(params, {"tokens": tokens}, cfg, staging)
    kv_err = max((a.float() - b.float()).abs().max().item()
                 for a, b in zip(tree_leaves(caches), tree_leaves(mono_cache)))
    kv_scale = max(b.float().abs().max().item()
                   for b in tree_leaves(mono_cache))
    c32, m32 = (x.float()[:, :cfg.vocab] for x in (logits, mono))
    if not (torch.isfinite(c32).all() and c32.shape == (1, cfg.vocab)):
        raise AssertionError("chunk_prefill logits not finite / wrong shape")
    err = (c32 - m32).abs().max().item()
    scale = m32.abs().max().item()
    same = bool(c32.argmax() == m32.argmax())
    log(f"chunk_prefill ({len(prompt)} tokens in chunks of {CHUNK}, staging "
        f"{staging}) vs monolithic prefill: last-chunk logits max abs err "
        f"{err:.4g} (logit scale {scale:.4g}, tolerance {LOGIT_TOL:.0%} of "
        f"it), same greedy pick {same}; staging K/V vs the prefill's cache "
        f"max abs err {kv_err:.4g} (scale {kv_scale:.4g})")
    if not err <= LOGIT_TOL * scale:
        raise AssertionError("chunk_prefill logits differ from prefill's "
                             "beyond the tolerance")
    chunk = tokens[:, :CHUNK]
    profile_step(torch, lambda: chunk_prefill_step(params, chunk, caches, 0,
                                                   CHUNK, cfg), 3,
                 f"chunk step (1 x {CHUNK} tokens into a {staging}-token "
                 f"staging, {cfg.n_layers} layers)",
                 cfg.param_count() * 2 / HBM_BYTES_PER_S * 1e3)


def chunked_prefill(torch, cfg, params, requests, mono_tokens):
    """Phase 3's requests through the chunked engine with the prefix cache
    on, then a shared-prefix workload warm (prefix cache on) and cold
    (off).  Returns the chunked arm's launches."""
    from repro_torch.serving import format_summary
    max_seq = max(len(p) + n for p, n, _ in requests)
    n_pages = len(requests) * -(-max_seq // 16)

    def submit_all(eng, reqs):
        for prompt, n_new, sampling in requests:
            reqs.append(eng.submit("gemma-7b", prompt, max_new_tokens=n_new,
                                   **sampling))
        eng.run()

    eng = chunked_engine(torch, cfg, params, max_seq, n_pages, True)
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    reqs, launches, chunks, batches, wall = run_chunked(torch, cfg, eng,
                                                        submit_all)
    summary = eng.summary()
    log(format_summary(summary))
    log_chunks(f"chunked arm (chunk {CHUNK}, budget {CHUNK_BUDGET}, page 16, "
               f"prefix cache on)", chunks)
    tokens = sum(len(r.generated) for r in reqs)
    agree = [r.generated == mono_tokens[r.rid] for r in reqs]
    same = sum(a == b for r in reqs
               for a, b in zip(r.generated, mono_tokens[r.rid]))
    # where each request's tokens first part from the monolithic arm's:
    # 0 is the prefill's own token, later ones a decode step's pick
    parted = [next((i for i, (a, b) in enumerate(
        zip(r.generated, mono_tokens[r.rid])) if a != b), None)
        for r in reqs]
    ttft = sorted(r.ttft * 1e3 for r in reqs)
    log(f"chunked arm: {len(reqs)} requests, {tokens} tokens in {wall:.3f} s "
        f"({len(eng.metrics.steps)} steps, {batches} decode batches, "
        f"{int(summary['prefill_chunks'])} chunks, "
        f"{int(summary['prefill_tokens'])} prompt tokens); TTFT "
        f"{', '.join(f'{t:.1f}' for t in ttft)} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({held:.2f} "
        f"GiB allocated before the run); launches {json.dumps(launches)}")
    log(f"greedy agreement with phase 3's monolithic arm: {sum(agree)} of "
        f"{len(reqs)} requests identical, {same} of {tokens} tokens equal "
        f"position by position; first differing token by request "
        f"{parted} (0 = the prefill's token)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    chunk_logits_check(torch, cfg, params,
                       max((p for p, _, _ in requests), key=len))

    rng = np.random.default_rng(2)
    shared = rng.integers(1, cfg.vocab, SHARED_PREFIX).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab,
                                     int(rng.integers(64, 201))).tolist()
               for _ in range(4)]
    max_seq = max(len(p) for p in prompts) + 16
    runs = {}
    for label, cache in (("warm", True), ("cold", False)):
        def submit_prefix(eng, reqs):
            reqs.append(eng.submit("gemma-7b", prompts[0],
                                   max_new_tokens=16))
            eng.run()
            reqs.extend(eng.submit("gemma-7b", p, max_new_tokens=16)
                        for p in prompts[1:])
            eng.run()

        eng = chunked_engine(torch, cfg, params, max_seq,
                             4 * -(-max_seq // 16), cache)
        reqs, _, chunks, batches, wall = run_chunked(torch, cfg, eng,
                                                     submit_prefix)
        summary = eng.summary()
        runs[label] = (summary, [list(r.generated) for r in reqs],
                       [r.ttft * 1e3 for r in reqs[1:]])
        log_chunks(f"prefix-cache arm, {label}", chunks)
        log(f"prefix-cache arm, {label}: {int(summary['prefill_tokens'])} "
            f"prompt tokens computed, {int(summary['prefix_hit_tokens'])} "
            f"served from cache, {int(summary['prefill_chunks'])} chunks, "
            f"{len(eng.metrics.steps)} steps in {wall:.3f} s; TTFT of the "
            f"three followers {', '.join(f'{t:.1f}' for t in runs[label][2])}"
            f" ms")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    (warm, warm_toks, _), (cold, cold_toks, _) = runs["warm"], runs["cold"]
    hit = 3 * SHARED_PREFIX
    if (warm["prefix_hit_tokens"], cold["prefix_hit_tokens"]) != (hit, 0):
        raise AssertionError(f"prefix cache: hit tokens warm "
                             f"{warm['prefix_hit_tokens']}, cold "
                             f"{cold['prefix_hit_tokens']}; want {hit}, 0")
    if cold["prefill_tokens"] - warm["prefill_tokens"] != hit:
        raise AssertionError(f"prefix cache: prompt tokens computed warm "
                             f"{warm['prefill_tokens']}, cold "
                             f"{cold['prefill_tokens']}; want {hit} apart")
    if warm_toks != cold_toks:
        raise AssertionError(f"prefix cache: warm tokens {warm_toks} differ "
                             f"from cold {cold_toks}")
    log(f"prefix cache: {hit} prompt tokens skipped warm, greedy tokens "
        f"equal warm and cold")
    return launches


# ------------------------------------------------------------ phase 8
SLOT_MAX_SEQ = 552             # the CLI's max_seq at --prompt-len 512 --gen 32
GREEDY = dict(smoke=False, batch=4, prompt_len=512, gen=32)   # its run


def slot_serve(torch, cfg, params, requests, mono_tokens):
    """Phase 3's requests through one slot tenant (8 slots of
    SLOT_MAX_SEQ tokens), with the launch counts set to 0 just before the
    run: 28 paged launches a decode batch, 28 flash launches a prefill,
    none of delta_apply, pulse_count or crossbar_mvm (one tenant, resident
    before the run), every first token (the prefill's) equal to phase 3's.
    Returns the launches of all five kernels."""
    from repro_torch.serving import (EngineModel, SchedulerConfig,
                                     ServingEngine, format_summary)
    from repro_torch.tree import tree_leaves
    eng = ServingEngine(
        [EngineModel("gemma-7b", params, cfg, kv_slots=8,
                     max_seq=SLOT_MAX_SEQ)],
        sched=SchedulerConfig(max_prefill_per_step=4), device="cuda")
    arena_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(eng.arenas["gemma-7b"].caches))
    for prompt, n_new, sampling in requests:
        eng.submit("gemma-7b", prompt, max_new_tokens=n_new, **sampling)
    eng.residency.ensure("gemma-7b", 0)       # set-up, as in phase 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    summary = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    reqs = list(eng.requests.values())
    if not all(r.status.value == "finished"
               and len(r.generated) == r.max_new_tokens
               and all(0 <= t < cfg.vocab for t in r.generated)
               for r in reqs):
        raise AssertionError("slot: not every request finished inside the "
                             "vocab: " + ", ".join(
                                 f"{r.rid}:{r.status.value}:"
                                 f"{len(r.generated)}" for r in reqs))
    decode_batches = sum(1 for st in eng.metrics.steps if st.n_decoded)
    prefills = sum(st.n_prefills for st in eng.metrics.steps)
    want = {"paged_attention": cfg.n_layers * decode_batches,
            "flash_attention": cfg.n_layers * prefills,
            "delta_apply": 0, "pulse_count": 0, "crossbar_mvm": 0}
    if launches != want or prefills != len(requests):
        raise AssertionError(f"slot: launches {launches}, want {want} "
                             f"({prefills} prefills)")
    first = [r.generated[0] == mono_tokens[r.rid][0] for r in reqs]
    identical = sum(r.generated == mono_tokens[r.rid] for r in reqs)
    tokens = sum(len(r.generated) for r in reqs)
    same = sum(a == b for r in reqs
               for a, b in zip(r.generated, mono_tokens[r.rid]))
    parted = [next((i for i, (a, b) in enumerate(
        zip(r.generated, mono_tokens[r.rid])) if a != b), None)
        for r in reqs]
    log(format_summary(summary))
    log(f"slot engine: {len(reqs)} requests, {tokens} tokens in {wall:.3f} "
        f"s = {tokens / wall:.1f} tok/s; {len(eng.metrics.steps)} steps, "
        f"{decode_batches} decode batches, {prefills} prefills; arena "
        f"{arena_bytes:,} B (8 slots x {SLOT_MAX_SEQ} tokens); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{json.dumps(launches)}")
    log(f"slot engine vs phase 3 (paged): first tokens equal in "
        f"{sum(first)} of {len(reqs)} requests; {identical} requests "
        f"identical, {same} of "
        f"{tokens} tokens equal position by position; first differing token "
        f"by request {parted} (0 = the prefill's token)")
    if not all(first):
        raise AssertionError("slot: a first token differs from phase 3's")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def slot_first_step(torch, cfg, params, requests):
    """The 8 prompts prefilled into a fresh slot arena, then its first
    batched decode step through the kernels and through the plain
    versions, on identical caches: logits within LOGIT_TOL of the logit
    scale.  Then the step is profiled."""
    from repro_torch.launch.steps import cached_serve_step, prefill_step
    from repro_torch.serving import KVArena
    from repro_torch.tree import tree_leaves
    arena = KVArena(cfg, 8, SLOT_MAX_SEQ, device="cuda")
    for rid, (prompt, _, _) in enumerate(requests[:8]):
        slot = arena.alloc(rid)
        logits, one = prefill_step(
            params, {"tokens": torch.tensor([prompt], device="cuda")},
                                   cfg, SLOT_MAX_SEQ)
        arena.install(slot, one, int(logits[0, :cfg.vocab].argmax()),
                      len(prompt))
    saved = [t.clone() for t in tree_leaves(arena.caches)]
    tok, pos = arena.decode_inputs()
    serve_step = cached_serve_step(cfg)
    k_logits, _ = serve_step(params, tok, arena.caches, pos)
    for t, s in zip(tree_leaves(arena.caches), saved):
        t.copy_(s)
    with plain_attention():
        p_logits, _ = serve_step(params, tok, arena.caches, pos)
    for t, s in zip(tree_leaves(arena.caches), saved):
        t.copy_(s)
    del saved
    k32, p32 = (x.float()[:, :cfg.vocab] for x in (k_logits, p_logits))
    if not (torch.isfinite(k32).all() and k32.shape == (8, cfg.vocab)):
        raise AssertionError("slot decode logits not finite / wrong shape")
    err = (k32 - p32).abs().max().item()
    scale = p32.abs().max().item()
    agree = (k32.argmax(-1) == p32.argmax(-1)).float().mean().item()
    log(f"slot decode step (8 slots of {SLOT_MAX_SEQ}, positions "
        f"{sorted(pos.tolist())}), kernels vs plain: logits max abs err "
        f"{err:.4g} (logit scale {scale:.4g}, tolerance {LOGIT_TOL:.0%} of "
        f"it), greedy agreement {agree:.3f}")
    if not err <= LOGIT_TOL * scale:
        raise AssertionError("slot decode logits: kernels and plain "
                             "versions differ beyond the tolerance")
    profile_step(torch, lambda: serve_step(params, tok, arena.caches, pos),
                 5,
                 f"slot decode step (8 rows, {cfg.n_layers} layers)",
                 cfg.param_count() * 2 / HBM_BYTES_PER_S * 1e3)
    del arena
    gc.collect()
    torch.cuda.empty_cache()


def greedy_vs_plain(torch, cfg, params, toks, greedy=None):
    """The default mode's prefill and every decode step of its loop, run
    again twice on its own inputs (`make_batch`'s batch, then `toks`, the
    loop's tokens, fed back at positions prompt_len + prefix + i, prefix
    a prefix VLM's image positions): through the kernels, and with both
    wrappers swapped for their plain versions, each on its own caches.
    Every step's logits within LOGIT_TOL of the logit scale; so the page
    view of the default mode's cache (p 16, T 34 for gemma-7b's run, one
    position for every row) is held at each of the loop's positions.  On
    a MoE model the plain run is pinned to the kernel run's experts
    (`pinned_route`).  Returns (max abs err, logit scale, greedy
    agreement, tokens of the kernels' rerun equal to the loop's, and for
    a MoE model (the unpinned error, the share of expert sets that
    differ), else None)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.steps import cached_prefill_step, cached_serve_step
    greedy = greedy or GREEDY
    B, S, gen = greedy["batch"], greedy["prompt_len"], greedy["gen"]
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in make_batch(
        cfg, DataConfig(seq_len=S, global_batch=B), 0).items()}
    pos = S + (cfg.prefix_len if cfg.input_mode == "prefix_vlm" else 0)
    fed = torch.as_tensor(toks, device="cuda")
    prefill, step = cached_prefill_step(cfg, pos + gen), cached_serve_step(cfg)

    def run():
        logits, caches = prefill(params, batch)
        out = [logits.float()]
        for i in range(gen - 1):
            logits, caches = step(params, fed[:, i], caches, pos + i)
            out.append(logits.float())
        return torch.stack(out, 1)

    k_picks, p_picks = [], []
    with recording_route(k_picks):
        k32 = run()
    with plain_attention(), recording_route(p_picks):
        p32 = run()
    if not (torch.isfinite(k32).all()
            and k32.shape == (B, gen, cfg.vocab_padded)):
        raise AssertionError("default mode logits not finite / wrong shape")
    free_err = (k32 - p32).abs().max().item()
    scale = p32.abs().max().item()
    agree = (k32.argmax(-1) == p32.argmax(-1)).float().mean().item()
    same = int((k32.argmax(-1) == fed.long()).sum())
    if not k_picks:                         # a dense model: nothing routes
        return free_err, scale, agree, same, None
    # MoE routing is discontinuous: the plain run again, pinned to the
    # kernel run's experts, leaves the attention's difference alone
    with plain_attention(), pinned_route(k_picks, {"calls": 0,
                                                   "offset": 0}):
        q32 = run()
    return ((k32 - q32).abs().max().item(), scale, agree, same,
            (free_err, routing_flips(k_picks, p_picks)))


def kernel_layers(cfg):
    """(layers whose monolithic prefill launches the flash kernel, layers
    whose slot decode launches the paged kernel) in `cfg`'s stack:
    attention (causal, or an encoder's full attention) with no window and
    no logit softcap; MLA decodes with no kernel, mLSTM / sLSTM layers
    have no attention, and a prefix VLM's prefill (its image positions
    seen by every query) takes the masked softmax."""
    from repro_torch.nn.transformer import layer_kind
    paged = sum(1 for i in range(cfg.n_layers)
                if layer_kind(cfg, i) in ("attn", "hybrid")
                and cfg.window_for_layer(i) <= 0 and cfg.logit_softcap <= 0)
    flash = 0 if cfg.input_mode == "prefix_vlm" else paged
    return flash, 0 if cfg.attn_type == "mla" else paged


def default_mode(torch, cfg, params, greedy=None):
    """The launcher without a mode flag (`serve.run_greedy`, the function
    its CLI calls) on `params` with `greedy`'s flags: one B x S prefill,
    gen - 1 greedy decode steps at a scalar position, launch counts set
    to 0 just before and read just after; then every step's logits held
    against the plain versions (`greedy_vs_plain`).  `cfg` is the
    registry's config of `cfg.name` or one cut in depth, which the
    launcher is handed in place of the registry's.  Returns the launches."""
    import argparse
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.launch import serve
    greedy = greedy or GREEDY
    args = argparse.Namespace(arch=cfg.name, device="cuda", **greedy)
    zero_launch_counts()
    with mock.patch.object(serve, "get_config", lambda name, smoke: cfg):
        toks, t_prefill, t_decode = serve.run_greedy(args, params)
    launches = {"paged_attention": paged_attention.launches,
                "flash_attention": flash_attention.launches}
    flash_layers, paged_layers = kernel_layers(cfg)
    want = {"paged_attention": paged_layers * (greedy["gen"] - 1),
            "flash_attention": flash_layers}
    if launches != want or toks.shape != (greedy["batch"], greedy["gen"]) \
            or not ((0 <= toks) & (toks < cfg.vocab_padded)).all():
        raise AssertionError(f"default mode: launches {launches}, want "
                             f"{want}; tokens {toks.shape}")
    log(f"default mode, {cfg.name} at {cfg.n_layers} layers (batch "
        f"{greedy['batch']} x {greedy['prompt_len']} "
        f"tokens, {greedy['gen']} new): prefill {t_prefill * 1e3:.1f} ms, "
        f"{greedy['gen'] - 1} decode steps {t_decode * 1e3:.1f} ms "
        f"({(greedy['gen'] - 1) / t_decode:.2f} steps/s, "
        f"{(greedy['gen'] - 1) * greedy['batch'] / t_decode:.1f} tok/s); "
        f"launches {json.dumps(launches)}")
    err, scale, agree, same, routed = greedy_vs_plain(torch, cfg, params,
                                                      toks, greedy)
    pinned = ("" if routed is None else
              f" with the plain run pinned to the kernel run's experts "
              f"({routed[0]:.4g} routed by itself, expert sets differing in "
              f"{routed[1]:.2%} of (layer, token))")
    log(f"default mode, prefill and {greedy['gen'] - 1} decode steps on the "
        f"loop's tokens, kernels vs plain: logits max abs err {err:.4g}"
        f"{pinned} (logit scale {scale:.4g}, tolerance {LOGIT_TOL:.0%} of "
        f"it), greedy agreement {agree:.3f}; the kernels' rerun picks the "
        f"loop's token in {same} of {toks.size}")
    if not err <= LOGIT_TOL * scale:
        raise AssertionError("default mode logits: kernels and plain "
                             "versions differ beyond the tolerance")
    return launches


# runs `--engine` as the CLI does (its own parser and `_run_engine`) and
# prints the kernel launches and the residency's pair costs of the run
CLI_RUNNER = """
import json, sys
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.pulse_count.ops import pulse_count
from repro_torch.launch import serve
eng = serve._run_engine(serve._parser().parse_args(sys.argv[1:]))
print(json.dumps({"pair_costs": len(eng.residency._cost_cache),
                  "decode_batches": sum(1 for s in eng.metrics.steps
                                        if s.n_decoded),
                  "paged_attention": paged_attention.launches,
                  "flash_attention": flash_attention.launches,
                  "pulse_count": pulse_count.launches}))
"""


def default_cli(torch):
    """`python -m repro_torch.launch.serve --engine --smoke --virtual-clock
    --trace-out T --metrics-json M` in a subprocess, through the CLI's own
    parser and engine run: exit 0, a trace and a metrics file that parse,
    every request's lifecycle queued ... finished, and one pulse_count
    launch per residency pair cost.  Returns the subprocess's launches."""
    import tempfile
    from repro_torch.configs import get_config
    smoke = get_config("gemma-7b", smoke=True)
    with tempfile.TemporaryDirectory() as tmp:
        trace, metrics = (os.path.join(tmp, n) for n in ("t.json",
                                                          "m.json"))
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", CLI_RUNNER, "--engine", "--smoke",
             "--virtual-clock", "--trace-out", trace, "--metrics-json",
             metrics], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"default CLI exited {run.returncode}: "
                                 f"{run.stderr[-2000:]}")
        lines = run.stdout.strip().splitlines()
        counts = json.loads(lines[-1])
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        with open(metrics) as f:
            doc = json.load(f)
    for line in lines[:-1]:
        log(f"  | {line}")
    phases = {}
    for e in events:
        if e.get("pid") == 1 and e["ph"] != "M" \
                and not e["name"].endswith(":enter"):
            phases.setdefault(e["tid"], []).append(e["name"])
    summary = doc["summary"]
    n_req = int(summary["requests_finished"])
    balanced = all(p[0] == "queued" and p[-1] == "finished"
                   for p in phases.values())
    want = {"paged_attention": smoke.n_layers * counts["decode_batches"],
            "pulse_count": counts["pair_costs"]}
    launches = {k: counts[k] for k in ("paged_attention", "flash_attention",
                                       "pulse_count")}
    log(f"default CLI (--engine --smoke --virtual-clock, slot layout, two "
        f"tenants through {smoke.n_layers + 1} weight slots): exit 0 in "
        f"{wall:.1f} s; {len(events)} trace events, {len(phases)} request "
        f"lifecycles balanced {balanced}; {n_req} requests finished, "
        f"{int(summary['installs'])} installs "
        f"({int(summary['cross_tenant_installs'])} cross-tenant), "
        f"{counts['pair_costs']} residency pair costs; launches "
        f"{json.dumps(launches)}")
    if not (balanced and len(phases) == n_req == 10
            and all(counts[k] == v for k, v in want.items())
            and counts["pulse_count"] > 0):
        raise AssertionError(f"default CLI: {n_req} requests, lifecycles "
                             f"balanced {balanced}, counts {counts}, want "
                             f"{want}")
    return launches



# ------------------------------------------------------------ phase 9
PLANES_DIR = os.path.join(ROOT, "build", "phase9")   # gitignored
# Seeded stuck-at faults at 0.4% per physical write.  The stream is a pure
# function of (seed, plane, unit, write ordinal), and seed 6125003 gives:
# weight slot 11 faults at its first write (the cold installs at step 0
# fill slots 0-27 in order, so slot 11 is retired for sure) and no other
# weight slot faults in its first 40 writes (the arena of n_layers + 2
# would survive two); two first-write faults among pages 1-4 of the two KV
# planes (a tenant's first request takes its pages 1-4 first, so two pages
# are retired for sure).  `fault_plan` recomputes this before the run.
FAULT_RATE = 0.004
FAULT_SEED = 6125003
SLO_ITL_P95_S = 0.02           # below the host-bound decode step
SLO_TTFT_P95_S = 1.0
STALL_TIMEOUT_S = 2.0          # below a first switch's pair accounting
FLIGHT_STEPS = 64
PROFILED_STEPS = range(32, 44)  # after both first switches
CAPTURE_FROM = 20              # B's first later decode over retired pages


def fault_plan(n_slots, planes=("kv:tenant-a", "kv:tenant-b")):
    """The fault stream's decisions that make phase 9's plan (see
    FAULT_SEED): weight slots faulting at their first write, weight-plane
    faults in the first 40 writes of every slot, and first-write faults of
    KV pages 1-4; checked before the run."""
    from repro_torch.serving import FaultModel
    u = FaultModel(FAULT_RATE, FAULT_SEED)._uniform
    first = [s for s in range(n_slots) if u("weight", s, 0) < FAULT_RATE]
    window = sum(u("weight", s, k) < FAULT_RATE
                 for s in range(n_slots) for k in range(40))
    pages = [(p, g) for p in planes for g in range(1, 5)
             if u(p, g, 0) < FAULT_RATE]
    if not (first and min(first) < n_slots - 2 and window <= 2
            and len(pages) >= 2):
        raise AssertionError(f"fault plan: first-write slot faults {first}, "
                             f"{window} in the weight window, first-write "
                             f"page faults {pages}")
    return first, window, pages


def planes_pages(requests):
    """(max_seq, pages a tenant) of phase 9's paged arenas: 4 rows of
    max_seq tokens at page 16, and 16 pages of headroom."""
    max_seq = max(len(p) + n for _, p, n in requests)
    return max_seq, 4 * -(-max_seq // 16) + 16


def planes_paged_shape(cfg):
    """(label, check_paged arguments) of phase 9's decode calls: its 4
    rows of gemma-7b's heads over a table as wide as a tenant's pool, so
    the split plan phase 9 launches; positions from the first decode to
    the longest request's last, no page 0 and, as in arm B's tenant-b, not
    the retired pages 3 and 4."""
    max_seq, n_pages = planes_pages(two_tenant_requests(cfg))
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    label = (f"phase 9 B4 Hkv{Hkv} G{H // Hkv} D{D} page16 T{n_pages} "
             f"(pages 3, 4 retired)")
    return label, dict(B=4, H=H, Hkv=Hkv, D=D, page=16, T=n_pages, seed=13,
                       pos_list=[64, 160, 255, max_seq - 1], skip=(3, 4))


def read_endpoint(url):
    """One GET of the local /metrics endpoint, with no proxy in the way."""
    import urllib.request
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url, timeout=30) as r:
        return r.read().decode()


def planes_engine(torch, cfg, tenants, requests, **knobs):
    """Phase 6's two tenants and requests, every request submitted up
    front, on the paged layout at page 16 (4 decode rows a tenant, 16
    pages of headroom) behind an arena of n_layers + 2 slots with instant
    installs, on the engine's real clock; `knobs` are the planes.  Its
    `_observe_step` is timed into `eng.observe_s`.  Returns (engine, build
    s)."""
    from repro_torch.serving import EngineModel, SchedulerConfig, ServingEngine
    max_seq, n_pages = planes_pages(requests)
    t0 = time.perf_counter()
    eng = ServingEngine(
        [EngineModel(name, params, cfg, kv_slots=4, max_seq=max_seq,
                     kv_layout="paged", page_size=16, n_pages=n_pages)
         for name, params in tenants.items()],
        weight_arena_slots=cfg.n_layers + 2,
        sched=SchedulerConfig(max_prefill_per_step=4,
                              model_turn_steps=TURN_STEPS),
        device="cuda", **knobs)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    for model, prompt, n_new in requests:
        eng.submit(model, prompt, max_new_tokens=n_new)
    eng.observe_s, observe_step = [], eng._observe_step

    def timed_observe(*args):
        t = time.perf_counter()
        observe_step(*args)
        eng.observe_s.append(time.perf_counter() - t)

    eng._observe_step = timed_observe
    return eng, t_build


def step_in_turns(torch, engines, hook=None, max_steps=2000):
    """Drive the engines' steps in turns (one step of each, in order, while
    it has work), so that both arms' step k run side by side in time and
    the host's drift between them cancels.  `hook(i, k)` may return a
    context manager to run engine i's step k in (a profiler, a capture);
    such a step's wall is None.  Returns, per engine, its step walls (s)
    and the launches of each kernel made in its own steps."""
    from repro_torch.kernels.crossbar_mvm.ops import crossbar_mvm
    from repro_torch.kernels.delta_apply.ops import apply_delta
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.pulse_count.ops import pulse_count
    counters = {"paged_attention": paged_attention,
                "flash_attention": flash_attention,
                "pulse_count": pulse_count, "delta_apply": apply_delta,
                "crossbar_mvm": crossbar_mvm}
    walls = [[] for _ in engines]
    launches = [dict.fromkeys(counters, 0) for _ in engines]
    zero_launch_counts()
    for k in range(max_steps):
        if not any(e.has_work() for e in engines):
            break
        for i, (eng, wall, counts) in enumerate(zip(engines, walls,
                                                    launches)):
            if not eng.has_work():
                continue
            before = {n: c.launches for n, c in counters.items()}
            ctx = hook and hook(i, k)
            if ctx is None:
                t = time.perf_counter()
                eng.step()
                wall.append(time.perf_counter() - t)
            else:
                with ctx:
                    eng.step()
                wall.append(None)
            for n, c in counters.items():
                counts[n] += c.launches - before[n]
    else:
        raise AssertionError(f"planes: work left after {max_steps} steps")
    torch.cuda.synchronize()
    return walls, launches


@contextlib.contextmanager
def profiled(prof):
    """Run the block under one cProfile.Profile."""
    prof.enable()
    try:
        yield
    finally:
        prof.disable()


@contextlib.contextmanager
def capture_paged(arena, out):
    """Run the block with the decode step's paged_attention calls going
    through a shim that, if the first call's table is `arena`'s, stores a
    copy of that call's arguments in `out`; every call still launches the
    kernel."""
    from repro_torch.nn import attention as attn_mod
    real, first = attn_mod.paged_attention, []

    def record(q, kp, vp, table, pos):
        if not first:
            first.append(True)
            if np.array_equal(table.cpu().numpy(), arena.tables_np):
                out["args"] = tuple(x.clone() for x in (q, kp, vp, table,
                                                        pos))
        return real(q, kp, vp, table, pos)

    with mock.patch.object(attn_mod, "paged_attention", record):
        yield


def planes_profile(profiles, steps, path):
    """Host time by function of the profiled steps that are decode-only
    in both arms (profiles[i] maps a step to its cProfile.Profile), as
    arm B minus arm A per step; writes the whole table to `path` and
    returns (steps, A and B profiled ms a step, the 12 largest rows)."""
    import pstats
    ks = sorted(k for k in profiles[0] if k in profiles[1] and all(
        r[k].n_decoded and not r[k].n_prefills
        and not r[k].install_wire_bytes for r in steps))
    if not ks:
        raise AssertionError("planes: no profiled decode-only step")
    own = []
    for prof in profiles:
        st = pstats.Stats(prof[ks[0]])
        for k in ks[1:]:
            st.add(prof[k])
        own.append({f"{os.path.basename(f)}:{line}({fn})": v[2] * 1e3
                    / len(ks) for (f, line, fn), v in st.stats.items()})
    a, b = own
    rows = sorted(((b.get(n, 0.0) - a.get(n, 0.0), a.get(n, 0.0),
                    b.get(n, 0.0), n) for n in set(a) | set(b)),
                  reverse=True)
    with open(path, "w") as f:
        f.write("own ms a step: B - A, A, B, function\n")
        for row in rows:
            f.write("%.4f %.4f %.4f %s\n" % row)
    return ks, sum(a.values()), sum(b.values()), rows[:12]


def planes(torch, cfg, base):
    """Phase 9: two gemma-7b tenants at full width (tenant-b phase 6's 2%
    perturbation) on one schedule in two arms, stepped in turns: (A) every
    knob off; (B) wear-aware placement, seeded stuck-at faults, telemetry
    with ITL and TTFT SLOs, events JSONL, a flight recorder of
    FLIGHT_STEPS steps, the step watchdog at STALL_TIMEOUT_S, the wear map
    and Prometheus text into build/phase9, and /metrics served on
    localhost and read once.  B's greedy tokens must equal A's for every
    request; B retires >= 1 weight slot and >= 2 KV pages, leaves >= 1
    stall_suspected dump and valid exporters, and spreads weight-slot
    writes over its slots in service no less evenly than A (what the
    wear-aware blend levels).  One of B's decode calls over the tables
    of the tenant with retired pages is held against the plain version;
    PROFILED_STEPS of both arms run under cProfile, for the planes' host
    time by function.  Then (C) the wear-aware blend alone, on its own,
    to part the blend's and the faults' shares of the weight Gini of cell
    flips (printed for A, B and C; B <= A is printed, not required).
    Returns the launches of arms A and B."""
    import cProfile
    import shutil
    from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                         split_plan)
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    from repro_torch.serving import (FlightRecorder, PromEndpoint,
                                     SLOConfig, TelemetryConfig,
                                     gini_coefficient, prometheus_text,
                                     validate_events_jsonl,
                                     validate_prometheus_text)
    t_phase = time.perf_counter()
    n_slots = cfg.n_layers + 2
    first, window, pages = fault_plan(n_slots)
    log(f"fault plan (rate {FAULT_RATE}, seed {FAULT_SEED}): weight slots "
        f"faulting at their first write {first}, {window} weight faults in "
        f"the first 40 writes of {n_slots} slots, first-write page faults "
        f"{pages}")
    variant = perturb_on_device(torch, base)
    tenants = {"tenant-a": base, "tenant-b": variant}
    requests = two_tenant_requests(cfg)
    shutil.rmtree(PLANES_DIR, ignore_errors=True)
    os.makedirs(PLANES_DIR)
    slo = SLOConfig(ttft_p95_s=SLO_TTFT_P95_S, itl_p95_s=SLO_ITL_P95_S)
    events = os.path.join(PLANES_DIR, "events.jsonl")
    recorder = FlightRecorder(FLIGHT_STEPS, out_dir=PLANES_DIR, max_dumps=64)
    eng_a, build_a = planes_engine(torch, cfg, tenants, requests)
    eng_b, build_b = planes_engine(
        torch, cfg, tenants, requests, wear_aware=1.0, fault_rate=FAULT_RATE,
        fault_seed=FAULT_SEED,
        telemetry=TelemetryConfig(slo=slo, events_path=events),
        recorder=recorder, stall_timeout_s=STALL_TIMEOUT_S)
    profiles, capture = ({}, {}), {}

    def hook(i, k):
        if k in PROFILED_STEPS:
            profiles[i][k] = cProfile.Profile()
            return profiled(profiles[i][k])
        if i == 1 and k >= CAPTURE_FROM and "args" not in capture:
            name = max(eng_b.arenas, key=lambda n: len(
                eng_b.arenas[n].allocator.retired))
            capture["tenant"] = name
            return capture_paged(eng_b.arenas[name], capture)
        return None

    t0 = time.perf_counter()
    (walls_a, walls_b), (launches_a, launches_b) = step_in_turns(
        torch, (eng_a, eng_b), hook)
    t_serve = time.perf_counter() - t0
    eng_b.telemetry.close()
    render = lambda: prometheus_text(eng_b.metrics.registry,  # noqa: E731
                                     eng_b.telemetry)
    endpoint = PromEndpoint(0, render)
    try:
        scraped = read_endpoint(f"http://127.0.0.1:{endpoint.port}/metrics")
    finally:
        endpoint.close()
    prom = render()
    with open(os.path.join(PLANES_DIR, "prom.txt"), "w") as f:
        f.write(prom)
    with open(os.path.join(PLANES_DIR, "wear.json"), "w") as f:
        json.dump(eng_b.wear.as_json(), f, indent=2, sort_keys=True)
        f.write("\n")
    with open(events) as f:
        event_text = f.read()
    errors = (validate_prometheus_text(scraped)
              + validate_prometheus_text(prom)
              + validate_events_jsonl(event_text))
    kinds = [json.loads(line)["type"] for line in event_text.splitlines()]
    dumps = {}
    for path in recorder.dumps:
        reason = os.path.basename(path).split("-", 2)[2][:-len(".json")]
        dumps[reason] = dumps.get(reason, 0) + 1
    health = eng_b.health()
    # arming and disarming the watchdog, outside a step
    t0 = time.perf_counter()
    for _ in range(200):
        with eng_b.watchdog.armed(-1):
            pass
    arm_ms = (time.perf_counter() - t0) / 200 * 1e3

    def arm_report(arm, eng, walls, launches, t_build):
        reqs = list(eng.requests.values())
        if not all(r.status.value == "finished"
                   and len(r.generated) == r.max_new_tokens
                   and all(0 <= t < cfg.vocab for t in r.generated)
                   for r in reqs):
            raise AssertionError(f"planes arm {arm}: not every request "
                                 f"finished inside the vocab")
        summary = eng.summary()
        writes = eng.wear.plane("weight").writes
        spread = gini_coefficient([w for slot, w in enumerate(writes)
                                   if slot not in eng.residency.retired])
        own = [w for w in walls if w is not None]
        log(f"planes arm {arm}: store built in {t_build:.2f} s; "
            f"{int(summary['tokens_generated'])} tokens in {sum(own):.3f} "
            f"s of its own unprofiled steps, {int(summary['steps'])} steps, "
            f"{int(summary['installs'])} installs, "
            f"{int(summary['preemptions'])} preemptions; launches "
            f"{json.dumps(launches)}")
        log(f"planes arm {arm}: install energy "
            f"{summary['install_energy_j'] * 1e3:.4f} mJ, KV write energy "
            f"{summary['kv_write_energy_j'] * 1e3:.4f} mJ, weight Gini "
            f"{summary['wear_gini_weight']:.4f} (cell flips; of writes "
            f"{spread:.4f} over the slots in service), KV Gini "
            f"{summary['wear_gini_kv']:.4f}; slots retired "
            f"{int(summary['slots_retired'])}, pages retired "
            f"{int(summary['pages_retired'])}, faults survived "
            f"{int(summary['faults_survived'])}")
        if not (launches["paged_attention"] and launches["flash_attention"]
                and launches["pulse_count"]
                and not launches["delta_apply"]
                and not launches["crossbar_mvm"]):
            raise AssertionError(f"planes arm {arm}: launches {launches}")
        return (summary, {r.rid: list(r.generated) for r in reqs}, spread,
                eng.metrics.steps)

    summary_a, tokens_a, spread_a, steps_a = arm_report(
        "A", eng_a, walls_a, launches_a, build_a)
    summary_b, tokens_b, spread_b, steps_b = arm_report(
        "B", eng_b, walls_b, launches_b, build_b)
    # decode-only steps (no prefill, no install) of both arms, paired by
    # step number, neither profiled nor captured: the host cost of the
    # planes, step k of A beside step k of B
    pairs = [(wa, wb) for wa, wb, ra, rb in zip(walls_a, walls_b, steps_a,
                                                steps_b)
             if wa is not None and wb is not None
             and all(r.n_decoded and not r.n_prefills
                     and not r.install_wire_bytes for r in (ra, rb))]
    med = statistics.median
    log(f"planes: steps in turns, {t_serve:.1f} s for both arms; "
        f"decode-only step wall over {len(pairs)} paired steps: A median "
        f"{med(a for a, _ in pairs) * 1e3:.2f} ms, B median "
        f"{med(b for _, b in pairs) * 1e3:.2f} ms, B - A median "
        f"{med(b - a for a, b in pairs) * 1e3:.2f} ms (B slower in "
        f"{sum(b > a for a, b in pairs)} of {len(pairs)}); the planes' own "
        f"host time in B: _observe_step median "
        f"{med(eng_b.observe_s) * 1e3:.3f} ms (max "
        f"{max(eng_b.observe_s) * 1e3:.3f}), arming and disarming the "
        f"watchdog {arm_ms:.3f} ms")
    ks, prof_a, prof_b, top = planes_profile(
        profiles, (steps_a, steps_b), os.path.join(PLANES_DIR,
                                                   "profile.txt"))
    log(f"planes: cProfile of {len(ks)} decode-only steps {ks} in each arm: "
        f"own time {prof_a:.2f} ms a step in A, {prof_b:.2f} in B (B - A "
        f"{prof_b - prof_a:.2f} ms, profiler included); largest B - A "
        f"(ms a step: B - A, A, B):")
    for d, a, b, name in top:
        log(f"  {d:+.4f} {a:.4f} {b:.4f} {name}")

    # one of B's decode calls over the tables of the tenant with retired
    # pages, against the plain version on the same inputs
    if "args" not in capture:
        raise AssertionError("planes: no decode call on the tables of the "
                             "tenant with retired pages captured")
    q, kp, vp, table, pos = capture["args"]
    tenant = capture["tenant"]
    plain = paged_attention_plain(q, kp, vp, table, pos)
    out = paged_attention(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    paged_err = (out.float() - plain.float()).abs().max().item()
    B, H, D = q.shape
    Hkv, T = kp.shape[2], table.shape[1]
    retired_b = eng_b.arenas[tenant].allocator.retired
    live = {int(x) for row, p in zip(table.tolist(), pos.tolist())
            for x in row[:p // kp.shape[1] + 1]}
    plan = split_plan(T, kp.shape[1], B * Hkv, H // Hkv, D, q.device)[:2]
    log(f"planes arm B: a decode call on {tenant}'s tables: B {B}, H {H}, "
        f"Hkv {Hkv}, D {D}, page {kp.shape[1]}, T {T}, positions "
        f"{pos.tolist()}, split plan (splits, pages a split) {plan}; "
        f"retired pages {sorted(retired_b)} named by no live table entry: "
        f"{not live & retired_b}; kernel vs plain max abs err "
        f"{paged_err:.3g} (tolerance {KERNEL_TOL})")
    if not (paged_err <= KERNEL_TOL and torch.isfinite(out).all()
            and retired_b and not live & retired_b):
        raise AssertionError(f"planes: captured decode call: err "
                             f"{paged_err}, live pages {sorted(live)}, "
                             f"retired {sorted(retired_b)}")
    del q, kp, vp, table, pos, plain, out, capture

    res = eng_b.residency
    max_writes = max(eng_b.faults._ordinal.get(("weight", s), 0)
                     for s in range(n_slots))
    retired_pages = {name: sorted(a.allocator.retired)
                     for name, a in eng_b.arenas.items()}
    log(f"planes arm B: retired weight slots {sorted(res.retired)}, "
        f"retired pages {json.dumps(retired_pages)}; fault checks "
        f"{eng_b.faults.checks}, faults {eng_b.faults.faults}; most writes "
        f"to one weight slot {max_writes}")
    log(f"planes arm B: watchdog fires {eng_b.watchdog.fires}; "
        f"{kinds.count('slo_breach')} slo_breach and "
        f"{kinds.count('slo_recover')} slo_recover events, "
        f"{kinds.count('step')} step and {kinds.count('finish')} finish "
        f"events; flight dumps by reason {json.dumps(dumps)} "
        f"({len(recorder.triggers)} triggers); health ok {health['ok']}, "
        f"slo {json.dumps(health.get('slo', {}))}")
    log(f"planes arm B: /metrics on 127.0.0.1:{endpoint.port} read once "
        f"({len(scraped)} bytes, {len(scraped.splitlines())} lines), "
        f"validator errors {errors}; wear map, events, Prometheus text, "
        f"profile and {len(recorder.dumps)} flight dumps in {PLANES_DIR}")

    same = sum(tokens_a[rid] == tokens_b[rid] for rid in tokens_a)
    log(f"planes: greedy tokens of B equal A's in {same} of "
        f"{len(tokens_a)} requests")
    if tokens_b != tokens_a:
        raise AssertionError(f"planes: the planes changed tokens: A "
                             f"{tokens_a}, B {tokens_b}")
    if not (summary_b["slots_retired"] >= 1
            and summary_b["pages_retired"] >= 2
            and summary_a["faults_survived"] == 0
            and dumps.get("stall_suspected", 0) >= 1
            and spread_b <= spread_a
            and not errors and scraped == prom):
        raise AssertionError(
            f"planes: slots retired {summary_b['slots_retired']}, pages "
            f"retired {summary_b['pages_retired']}, dumps {dumps}, Gini of "
            f"weight-slot writes in service {spread_b} vs {spread_a}, "
            f"exporter errors {errors}")
    del eng_a, eng_b, res
    gc.collect()
    torch.cuda.empty_cache()

    # (C) the blend alone, no faults, no telemetry
    eng_c, build_c = planes_engine(torch, cfg, tenants, requests,
                                   wear_aware=1.0)
    walls_c, launches_c = step_in_turns(torch, (eng_c,))
    summary_c, tokens_c, spread_c, _ = arm_report(
        "C (wear-aware alone)", eng_c, walls_c[0], launches_c[0], build_c)
    if tokens_c != tokens_a or summary_c["faults_survived"]:
        raise AssertionError(f"planes arm C: tokens {tokens_c} against A's "
                             f"{tokens_a}")
    flips = [s["wear_gini_weight"] for s in (summary_a, summary_c,
                                             summary_b)]
    log(f"planes: weight Gini of cell flips A {flips[0]:.4f}, C (wear-aware "
        f"alone) {flips[1]:.4f}, B (wear-aware and faults) {flips[2]:.4f}; "
        f"B <= A {'holds' if flips[2] <= flips[0] else 'does not hold'}, "
        f"C <= A {'holds' if flips[1] <= flips[0] else 'does not hold'} "
        f"(printed, not required); Gini of writes over the slots in "
        f"service A {spread_a:.4f}, C {spread_c:.4f}, B {spread_b:.4f} "
        f"(B <= A required)")
    del eng_c, variant
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9 (wear, faults, telemetry): "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches_a, launches_b

# ------------------------------------------------------------ phase 10
MLA_ARCH = "deepseek-v2-lite-16b"
# the dense and MoE GQA families through the default mode: full depth
# where the card holds the model beside the run (None), else cut layers
FAMILY_DEPTHS = {"minicpm-2b": None, "qwen3-32b": 8, "yi-34b": 8,
                 "qwen3-moe-235b-a22b": 2}
MOE_SPAN = "moe_layer"         # profiler range around each MoE layer


def phase3_requests(vocab):
    """Phase 3's 8 requests (prompt lengths, new tokens, sampling) with
    prompt tokens drawn below `vocab`: the same draws as phase 3's."""
    rng = np.random.default_rng(0)
    requests = []
    for i in range(8):
        n = int(rng.integers(32, 513))
        sampling = (dict(temperature=0.8, top_k=40, seed=7) if i == 3
                    else {})
        requests.append((rng.integers(1, vocab, n).tolist(),
                         int(rng.integers(16, 33)), sampling))
    return requests


def param_bytes(params):
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def family_serve(torch, cfg, params, requests, label, chunked=False,
                 max_seq=SLOT_MAX_SEQ, record=None, **model_kw):
    """`requests` through a one-tenant engine of `cfg` (8 rows of
    `max_seq`; the slot layout unless `model_kw` says otherwise; with
    `chunked`, chunks of CHUNK under a CHUNK_BUDGET-token budget), weights
    installed before the run, launch counts set to 0 just before it: every
    request finishes inside the vocab, flash launches once a monolithic
    prefill in each layer that takes it (`kernel_layers`; 0 chunked) and
    paged once a decode batch in each layer that takes it (MLA decodes
    with no kernel).  Returns (tokens by rid, launches, tokens per
    second).  With `record` (a dict), `decode_recorder` keeps every decode
    step's logits and the first decode step's MLA attention outputs; the
    host time it spends doing so is taken out of the tokens per second
    (its clones, a (B, vocab) copy a step, stay queued on the card)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.serving import (EngineModel, SchedulerConfig,
                                     ServingEngine)
    eng = ServingEngine(
        [EngineModel(cfg.name, params, cfg, kv_slots=8,
                     max_seq=max_seq, **model_kw)],
        sched=SchedulerConfig(max_prefill_per_step=4,
                              prefill_token_budget=(CHUNK_BUDGET if chunked
                                                    else None)),
        prefill_chunk=CHUNK if chunked else 0, device="cuda")
    for prompt, n_new, sampling in requests:
        eng.submit(cfg.name, prompt, max_new_tokens=n_new, **sampling)
    eng.residency.ensure(cfg.name, 0)          # set-up, as in phase 3
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    with (decode_recorder(torch, eng, cfg.name, record) if record is not None
          else contextlib.nullcontext()):
        eng.run()
    torch.cuda.synchronize()
    # the recorder's own host time is taken out of the clock
    wall = time.perf_counter() - t0 - (record or {}).get("seconds", 0.0)
    launches = {"paged_attention": paged_attention.launches,
                "flash_attention": flash_attention.launches}
    reqs = list(eng.requests.values())
    if not all(r.status.value == "finished"
               and len(r.generated) == r.max_new_tokens
               and all(0 <= t < cfg.vocab for t in r.generated)
               for r in reqs):
        raise AssertionError(f"{label}: not every request finished inside "
                             "the vocab")
    prefills = sum(st.n_prefills for st in eng.metrics.steps)
    decode_batches = sum(1 for st in eng.metrics.steps if st.n_decoded)
    flash_layers, paged_layers = kernel_layers(cfg)
    want = {"paged_attention": paged_layers * decode_batches,
            "flash_attention": 0 if chunked else flash_layers * prefills}
    if launches != want or prefills != len(requests):
        raise AssertionError(f"{label}: launches {launches}, want {want} "
                             f"({prefills} prefills)")
    n_tok = sum(len(r.generated) for r in reqs)
    log(f"{label}: {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tok/s; {len(eng.metrics.steps)} steps, "
        f"{decode_batches} decode batches, {prefills} prefills, "
        f"{eng.summary().get('prefill_chunks', 0):.0f} chunks; launches "
        f"{json.dumps(launches)}"
        + (f"; recorder's {record['seconds']:.3f} s of host time taken out"
           if record is not None else ""))
    tokens = {r.rid: list(r.generated) for r in reqs}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return tokens, launches, n_tok / wall


def decode_recorder(torch, eng, name, out):
    """A patch of `nn.model.forward` and `nn.attention._mla_absorbed` for
    one engine run: each decode step appends ({row: rid} of its running
    rows, its logits (B, vocab) kept on the card) to out["logits"], and
    the first decode step's absorbed MLA attention outputs, one a layer,
    go to out["attn"].  out["seconds"] adds up the host time the patch
    spends beyond the calls it wraps."""
    from repro_torch.nn import attention as attn_mod
    from repro_torch.nn import model as model_mod
    from repro_torch.serving import RequestStatus
    real_forward, real_absorbed = model_mod.forward, attn_mod._mla_absorbed
    out.update(logits=[], attn=[], seconds=0.0)

    def forward(params, batch, cfg, **kw):
        res = real_forward(params, batch, cfg, **kw)
        t0 = time.perf_counter()
        if torch.is_tensor(kw.get("cache_pos")):
            arena = eng.arenas[name]
            rows = {s: arena.owner_of(s) for s in arena.active_slots()
                    if eng.requests[arena.owner_of(s)].status
                    is RequestStatus.RUNNING}
            out["logits"].append((rows, res[0][:, 0, :cfg.vocab].clone()))
        out["seconds"] += time.perf_counter() - t0
        return res

    def absorbed(*args, **kw):
        o = real_absorbed(*args, **kw)
        t0 = time.perf_counter()
        if not out["logits"]:
            out["attn"].append(o.to(torch.bfloat16).clone())
        out["seconds"] += time.perf_counter() - t0
        return o

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(model_mod, "forward", forward))
    stack.enter_context(mock.patch.object(attn_mod, "_mla_absorbed",
                                          absorbed))
    return stack


def bf16_ulps(torch, a, b):
    """Per element, how many bf16 steps apart two bf16 tensors are."""
    ia, ib = (t.view(torch.int16).int() for t in (a, b))
    # the sign-magnitude bits as a monotone integer line
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return (ia - ib).abs()


def mla_parting(torch, cfg, requests, tokens, recs):
    """Where deepseek's slot and paged runs part (ROADMAP queue 3): for
    each greedy request, the first decode step whose token differs, the
    parted pick's logit lead in each run and the two runs' logit gap at
    that step; and, at the first decode step, how many bf16 ulps apart
    the two runs' MLA attention outputs are in each layer (layers 0 and 1
    attend before any routing).  Returns the numbers logged."""
    def row_of(rec, rid):
        return next(r for r, q in rec[0].items() if q == rid)

    parts = {}
    for rid, (_, _, sampling) in enumerate(requests):
        a, b = tokens["slot"][rid], tokens["paged"][rid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None or sampling or j == 0:
            parts[rid] = j if not sampling else "sampled"
            continue
        step = {}
        for run in ("slot", "paged"):
            seen = [rec for rec in recs[run]["logits"]
                    if rid in rec[0].values()]
            rec = seen[j - 1]                 # token j: decode step j - 1
            step[run] = rec[1][row_of(rec, rid)].float()
        ls, lp = step["slot"], step["paged"]
        parts[rid] = {
            "step": j, "tokens": [a[j], b[j]],
            "slot_lead": (ls[a[j]] - ls[b[j]]).item(),
            "paged_lead": (lp[b[j]] - lp[a[j]]).item(),
            "logit_gap": (ls - lp).abs().max().item(),
            "logit_scale": ls.abs().max().item()}
    first = {}
    sr = {q: r for r, q in recs["slot"]["logits"][0][0].items()}
    pr = {q: r for r, q in recs["paged"]["logits"][0][0].items()}
    common = sorted(set(sr) & set(pr))
    for layer, (x, y) in enumerate(zip(recs["slot"]["attn"],
                                       recs["paged"]["attn"])):
        xs, ys = x[[sr[q] for q in common]], y[[pr[q] for q in common]]
        u = bf16_ulps(torch, xs, ys)
        rel = ((xs.float() - ys.float()).abs().max()
               / xs.float().abs().max()).item()
        first[layer] = (int(u.max()), (u > 0).float().mean().item(), rel)
    log(f"{cfg.name} slot vs paged decode: first parting per request "
        f"{json.dumps(parts)}")
    log(f"{cfg.name} first decode step ({len(common)} rows in both runs), "
        f"MLA attention outputs slot vs paged, (max bf16 ulps, share "
        f"differing, max abs difference / max abs output) by layer: "
        f"{json.dumps(first)}")
    return {"parts": parts, "attn_ulps": first}


def recording_route(picks):
    """A stand-in for `nn.moe._route` that appends each call's (T, k)
    expert picks to `picks`: one entry a MoE layer for a whole prefill."""
    from repro_torch.nn import moe as moe_mod
    route = moe_mod._route

    def call(x, router, k):
        out = route(x, router, k)
        picks.append(out[2])
        return out
    return mock.patch.object(moe_mod, "_route", call)


def pinned_route(picks, state):
    """A stand-in for `nn.moe._route` that routes each call's tokens to
    the experts `picks` recorded (call i takes layer i mod len(picks),
    rows from `state["offset"]`, a chunk's start), the gates renormalized
    from the call's own probabilities: a second route through the model
    without the routing's discontinuity, so what is left of the
    difference is the attention's."""
    from repro_torch.nn import moe as moe_mod
    route = moe_mod._route

    def call(x, router, k):
        probs, _, _ = route(x, router, k)
        rows = slice(state["offset"], state["offset"] + x.shape[0])
        idx = picks[state["calls"] % len(picks)][rows]
        state["calls"] += 1
        vals = probs.gather(-1, idx)
        return probs, vals / vals.sum(-1, keepdim=True).clamp(min=1e-9), idx
    return mock.patch.object(moe_mod, "_route", call)


def routing_flips(a, b):
    """Share of (layer, token) expert sets that differ between two routes'
    recorded picks."""
    diff = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))
    return diff / sum(x.shape[0] for x in a)


def chunk_first_token_tie(torch, cfg, params, rid, request, picks):
    """A request whose first token parts between the monolithic prefill
    (flash, `picks[0]`) and the chunked one (the einsum over a staging
    cache, `picks[1]`): its prompt through both routes again (chunks of
    CHUNK).  The parting must be a near-tie: the monolithic pick's lead
    over the chunked one at most twice the two routes' max abs logit
    difference (what their rounding can move a difference of two logits
    by).  MoE routing is discontinuous (a top-k near-tie sends a token to
    another expert), so the routes are also compared with the chunked
    route pinned to the monolithic route's experts: those logits within
    LOGIT_TOL of the logit scale.  A sampled request is checked on its
    logits divided by its temperature, as the sampler sees them."""
    from repro_torch.launch.steps import chunk_prefill_step, prefill_step
    from repro_torch.nn.model import init_cache
    prompt, _, sampling = request
    tokens = torch.tensor([prompt], device="cuda")
    staging = -(-len(prompt) // CHUNK) * CHUNK
    mono_picks = []
    with recording_route(mono_picks):
        m_logits, _ = prefill_step(params, {"tokens": tokens}, cfg, staging)

    def chunked(pin):
        state = {"calls": 0, "offset": 0}
        seen = []
        patch = (pinned_route(mono_picks, state) if pin
                 else recording_route(seen))
        caches = init_cache(cfg, 1, staging, staging=True, device="cuda")
        with patch:
            for start in range(0, len(prompt), CHUNK):
                n = min(CHUNK, len(prompt) - start)
                state["offset"] = start
                logits, caches = chunk_prefill_step(
                    params, tokens[:, start:start + n], caches, start, n,
                    cfg)
        # per layer, the chunks' picks in token order
        n_moe = len(mono_picks)
        seen = [torch.cat(seen[i::n_moe]) for i in range(n_moe)] if seen \
            else None
        return logits, seen
    c_logits, c_picks = chunked(False)
    p_logits, _ = chunked(True)
    temp = sampling.get("temperature", 1.0)
    m32, c32, p32 = (x.float()[0, :cfg.vocab] / temp
                     for x in (m_logits, c_logits, p_logits))
    err = (c32 - m32).abs().max().item()
    pinned_err = (p32 - m32).abs().max().item()
    scale = m32.abs().max().item()
    a, b = picks
    lead = (m32[a] - m32[b]).item()
    how = sampling or "greedy"
    log(f"{cfg.name} request {rid} ({len(prompt)} tokens, {how}): first "
        f"token {a} monolithic, {b} chunked; lead of {a} over {b} {lead:.4g} "
        f"in the monolithic logits, {(c32[a] - c32[b]).item():.4g} in the "
        f"chunked; the routes' logits max abs diff {err:.4g} (scale "
        f"{scale:.4g}), expert sets differing in "
        f"{routing_flips(mono_picks, c_picks):.2%} of (layer, token); with "
        f"the chunked route pinned to the monolithic experts "
        f"{pinned_err:.4g} (tolerance {LOGIT_TOL:.0%} of the scale)")
    if not (abs(lead) <= 2 * err and pinned_err <= LOGIT_TOL * scale):
        raise AssertionError(f"{cfg.name} request {rid}: the chunked first "
                             f"token is no near-tie of the monolithic one")


def mla_prefill_vs_plain(torch, cfg, params, prompt):
    """The longest prompt's prefill logits through the flash kernel and
    with both wrappers swapped for their plain versions, the latter twice:
    routed by itself, and pinned to the kernel run's experts (MoE routing
    is discontinuous; pinned, what is left is the kernel's).  Returns (max
    abs error free, pinned, logit scale, same greedy pick, share of expert
    sets that differ)."""
    from repro_torch.launch.steps import prefill_step
    batch = {"tokens": torch.tensor([prompt], device="cuda")}
    k_picks, p_picks = [], []
    with recording_route(k_picks):
        k_logits, _ = prefill_step(params, batch, cfg, len(prompt))
    with plain_attention(), recording_route(p_picks):
        p_logits, _ = prefill_step(params, batch, cfg, len(prompt))
    with plain_attention(), pinned_route(k_picks, {"calls": 0, "offset": 0}):
        q_logits, _ = prefill_step(params, batch, cfg, len(prompt))
    k32, p32, q32 = (x.float()[:, :cfg.vocab]
                     for x in (k_logits, p_logits, q_logits))
    if not (torch.isfinite(k32).all() and k32.shape == (1, cfg.vocab)):
        raise AssertionError("MLA prefill logits not finite / wrong shape")
    return ((k32 - p32).abs().max().item(), (k32 - q32).abs().max().item(),
            p32.abs().max().item(), bool(k32.argmax(-1) == p32.argmax(-1)),
            routing_flips(k_picks, p_picks))


def mla_decode_profile(torch, cfg, params, requests):
    """The 8 prompts prefilled into a slot arena of SLOT_MAX_SEQ, then its
    batched decode step: the experts its routing hits in each MoE layer
    (recorded from `_route`), two weight-read bounds (every weight the
    function reads as written, every expert included; and only the
    experts this step's routing hit), the step profiled, and the MoE
    layers' share of its device time (a profiler range around each).
    Returns a dict of the numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.launch.steps import cached_serve_step, prefill_step
    from repro_torch.nn import moe as moe_mod
    from repro_torch.nn import transformer as tf_mod
    from repro_torch.serving import KVArena
    from repro_torch.tree import tree_leaves
    arena = KVArena(cfg, 8, SLOT_MAX_SEQ, device="cuda")
    for rid, (prompt, _, _) in enumerate(requests[:8]):
        slot = arena.alloc(rid)
        logits, one = prefill_step(
            params, {"tokens": torch.tensor([prompt], device="cuda")},
                                   cfg, SLOT_MAX_SEQ)
        arena.install(slot, one, int(logits[0, :cfg.vocab].argmax()),
                      len(prompt))
    saved = [t.clone() for t in tree_leaves(arena.caches)]
    tok, pos = arena.decode_inputs()
    step = cached_serve_step(cfg)
    picks = []
    route = moe_mod._route

    def recording(*a):
        out = route(*a)
        picks.append(out[2])
        return out
    with mock.patch.object(moe_mod, "_route", recording):
        step(params, tok, arena.caches, pos)
    for t, s_ in zip(tree_leaves(arena.caches), saved):
        t.copy_(s_)
    del saved
    hit = [int(torch.unique(p).numel()) for p in picks]
    table = params["embedding"]["table"]
    read_all = param_bytes(params) - table.numel() * table.element_size() \
        + 8 * cfg.d_model * table.element_size()
    moe = next(seg["moe"] for seg in params["stack"]["segments"]
               if "moe" in seg)
    per_expert = sum(moe[k].shape[-2] * moe[k].shape[-1]
                     * moe[k].element_size()
                     for k in ("w_gate", "w_up", "w_down"))
    read_hit = read_all - sum(cfg.n_experts - h for h in hit) * per_expert
    wall_ms = profile_step(
        torch, lambda: step(params, tok, arena.caches, pos), 5,
        f"{cfg.name} slot decode step (8 rows, {cfg.n_layers} layers)",
        read_all / HBM_BYTES_PER_S * 1e3)
    orig = tf_mod.moe

    def spanned(*a, **k):
        with record_function(MOE_SPAN):
            return orig(*a, **k)
    with mock.patch.object(tf_mod, "moe", spanned), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step(params, tok, arena.caches, pos)
        torch.cuda.synchronize()
    device_ms = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.key != MOE_SPAN) / 1e3 / 5
    moe_ms = span_device_ms(prof, MOE_SPAN) / 5
    out = dict(wall_ms=wall_ms, device_ms=device_ms, moe_device_ms=moe_ms,
               read_all_gb=read_all / 1e9, read_hit_gb=read_hit / 1e9,
               bound_all_ms=read_all / HBM_BYTES_PER_S * 1e3,
               bound_hit_ms=read_hit / HBM_BYTES_PER_S * 1e3,
               experts_hit=hit, decode_tok_s=8 / (wall_ms / 1e3))
    share = (f"{moe_ms / device_ms:.1%}" if moe_ms and device_ms
             else "not measured")
    log(f"{cfg.name} decode step weight reads: {out['read_all_gb']:.2f} GB "
        f"as written (every expert; bound {out['bound_all_ms']:.2f} ms), "
        f"{out['read_hit_gb']:.2f} GB for the experts this step's routing "
        f"hit (bound {out['bound_hit_ms']:.2f} ms; experts hit of "
        f"{cfg.n_experts} per MoE layer: {hit}); MoE layers "
        f"{moe_ms:.2f} ms of {device_ms:.2f} ms device time ({share})")
    del arena
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_flash_mla(torch, S=512, seed=17, B=1, lse=False):
    """The flash wrapper at MLA's prefill shape (deepseek-v2-lite: H = Hkv
    = 16, q/k D 192, v D 128 zero-padded to 192 as
    `nn.attention._mla_attention` pads it; the wrapper pads all three to
    256), with `lse` in its training mode (each row's log-sum-exp too, as
    `nn.flash`'s Function launches it): kernel vs plain within KERNEL_TOL
    (lse within LSE_TOL), its time, the plain version's, SDPA's forward on
    the unpadded inputs, and the bound of the unpadded work (q, k, v read
    once, the D-128 output, and lse, written once; the causal pairs' q·k
    in D 192 and p·v in D 128)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, Dk, Dv = 16, 192, 128
    q, k = (torch.randn(B, S, H, Dk, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn(B, S, H, Dv, generator=g, device="cuda").to(torch.bfloat16)

    def kernel():
        out = flash_attention(q, k, F.pad(v, (0, Dk - Dv)), causal=True,
                              return_lse=lse)
        return (out[0][..., :Dv], out[1]) if lse else (out[..., :Dv], None)

    def plain():
        out = flash_attention_plain(q, k, F.pad(v, (0, Dk - Dv)), True,
                                    return_lse=lse)
        return (out[0][..., :Dv], out[1]) if lse else (out[..., :Dv], None)
    (out, out_lse), (ref, ref_lse) = kernel(), plain()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (out_lse - ref_lse).abs().max().item() if lse else 0.0
    if not (err <= KERNEL_TOL and lse_err <= LSE_TOL
            and torch.isfinite(out).all()):
        raise AssertionError(f"flash_attention at MLA's shape B{B} S{S} "
                             f"(lse {lse}) disagrees: o {err} (limit "
                             f"{KERNEL_TOL}), lse {lse_err} (limit "
                             f"{LSE_TOL})")
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    pairs = S * (S + 1) // 2
    n_bytes = 2 * B * S * H * (2 * Dk + 2 * Dv) + (4 * B * S * H if lse
                                                   else 0)
    n_flops = 2 * B * H * pairs * (Dk + Dv)
    return err, ms, plain_ms, lib_ms, bound_ms(n_bytes, n_flops)


def span_device_ms(prof, span):
    """Device time (ms) of the kernels launched inside every profiler
    range named `span`, summed."""
    from torch.autograd import DeviceType
    return max((e.device_time_total for e in prof.key_averages()
                if e.key == span and e.device_type == DeviceType.CPU),
               default=0) / 1e3


def top_kernels(prof, n=6):
    """The `n` device kernels with the most device time in a profile
    (MOE_SPAN's range on the device timeline left out): [(name, ms)]."""
    from torch.autograd import DeviceType
    ks = sorted((e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.key != MOE_SPAN),
                key=lambda e: -e.device_time_total)[:n]
    return [(e.key[:70], round(e.device_time_total / 1e3, 3)) for e in ks]


def moe_layer_params(cfg, params):
    """Each MoE layer's params, in layer order (a stacked segment's
    layers indexed out of its (L, ...) leaves)."""
    from repro_torch.nn.transformer import stack_plan
    from repro_torch.tree import tree_map
    out = []
    for seg, (_, length, scanned) in zip(params["stack"]["segments"],
                                         stack_plan(cfg)):
        if "moe" in seg:
            out.extend(tree_map(lambda a, i=i: a[i], seg["moe"])
                       if scanned else seg["moe"]
                       for i in range(length if scanned else 1))
    return out


def capturing_moe(records, span=None):
    """A stand-in for the blocks' `moe` that appends each call's (input,
    output) to `records` (unless None), the call inside a profiler range
    `span`."""
    from torch.profiler import record_function
    from repro_torch.nn import transformer as tf_mod
    orig = tf_mod.moe

    def call(p, x, cfg, decode=False):
        with (record_function(span) if span else contextlib.nullcontext()):
            y, aux = orig(p, x, cfg, decode=decode)
        if records is not None:
            records.append((x.clone(), y.clone()))
        return y, aux
    return mock.patch.object(tf_mod, "moe", call)


def recording_dispatch(records):
    """A stand-in for `nn.moe._pack_dispatch` that appends each call's
    inputs and integer outputs to `records`."""
    from repro_torch.nn import moe as moe_mod
    orig = moe_mod._pack_dispatch

    def call(xf, gate_vals, gate_idx, n_experts, capacity):
        out = orig(xf, gate_vals, gate_idx, n_experts, capacity)
        records.append({"xf": xf, "gate_vals": gate_vals,
                        "gate_idx": gate_idx, "capacity": capacity,
                        "flat_token": out[1], "slot": out[2]})
        return out
    return mock.patch.object(moe_mod, "_pack_dispatch", call)


def moe_mesh(torch, cfg, params, requests, card):
    """Phase 10's mesh readings on deepseek-v2-lite-16b's full-width
    params: a 1 x 1 (data, model) mesh on a one-rank NCCL group
    (`make_debug_mesh`), the longest prompt's prefill under it (the MoE
    layers on the all-to-all body at the config's capacity factor, flash
    launches counted) and one slot decode step (the replicated body).
    Each MoE layer's mesh output is held against the no-mesh `moe` on
    that layer's input captured in a no-mesh run (so that routing
    near-ties between two routes cannot move the comparison): the
    replicated body, and the all-to-all body at a capacity factor of E/k
    (no token dropped), within KERNEL_TOL (rtol and atol, the bf16
    tolerance); at the config's factor the dispatch's token ids, slots
    (-1 dropped) and keep flags equal, bit for bit, the CPU's
    `_pack_dispatch` on the same routing.  Prints the tokens dropped per
    layer, expert rows (E·cap against T·E), the MoE layers' device time
    in the mesh prefill against the no-mesh prefill, peak memory; then
    `compressed_psum_pod` over the one-rank group on layer 0's
    gradient-shaped tensors, its result and error equal to the CPU path's
    (over a one-rank gloo group).  The group is ended before the return.
    Returns a dict of the readings."""
    import dataclasses
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import prefill_step
    from repro_torch.nn import moe as moe_mod
    from repro_torch.nn.model import decode_step
    from repro_torch.parallel.compression import compressed_psum_pod
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.tree import tree_flatten, tree_map
    t_start = time.perf_counter()
    log(f"{cfg.name} under a 1 x 1 mesh, one NCCL rank ({card})")
    torch.cuda.reset_peak_memory_stats()
    prompt = max((p for p, _, _ in requests), key=len)
    T, E, k = len(prompt), cfg.n_experts, cfg.moe_topk
    batch = {"tokens": torch.tensor([prompt], device="cuda")}
    layers = moe_layer_params(cfg, params)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def prefill():
        logits, caches = prefill_step(params, batch, cfg, T + 1)
        torch.cuda.synchronize()
        return logits, caches

    # the no-mesh prefill: each MoE layer's input and output captured, the
    # layers' device time in profiler ranges
    plain = []
    with capturing_moe(plain, MOE_SPAN), profile(activities=acts) as prof:
        logits0, caches = prefill()
    moe_ms0 = span_device_ms(prof, MOE_SPAN)
    top0 = top_kernels(prof)
    tok = logits0[:, :cfg.vocab].argmax(-1)
    saved = [t.clone() for t in tree_flatten(caches)]
    dec_plain = []
    with capturing_moe(dec_plain):
        decode_step(params, tok, caches, T, cfg)
    for t, s_ in zip(tree_flatten(caches), saved):
        t.copy_(s_)
    del saved
    mesh = make_debug_mesh(1, 1)
    try:
        with use_mesh(mesh):
            # the slice's main path: the prefill and a decode step on the
            # mesh, launch counts set to 0 just before
            dispatch, bodies = [], []
            rep = moe_mod._moe_body_replicated
            torch.cuda.synchronize()
            zero_launch_counts()
            with recording_dispatch(dispatch), mock.patch.object(
                    moe_mod, "_moe_body_replicated",
                    lambda *a: bodies.append(1) or rep(*a)):
                logits1, _ = prefill()
                logits_d, _ = decode_step(params, tok, caches, T, cfg)
                torch.cuda.synchronize()
            launches = launch_counts()
            flash_layers, _ = kernel_layers(cfg)
            want = dict({n: 0 for n in launches},
                        flash_attention=flash_layers)
            if launches != want:
                raise AssertionError(f"mesh prefill + decode: launches "
                                     f"{launches}, want {want}")
            if len(dispatch) != len(layers) or len(bodies) != len(layers):
                raise AssertionError(
                    f"mesh run: {len(dispatch)} all-to-all dispatches and "
                    f"{len(bodies)} replicated bodies for {len(layers)} MoE "
                    f"layers")
            for name, x in (("prefill", logits1), ("decode", logits_d)):
                if not (torch.isfinite(x.float()).all()
                        and tuple(x.shape) == (1, cfg.vocab_padded)):
                    raise AssertionError(f"mesh {name} logits not finite / "
                                         f"wrong shape")
            # the dispatch at the config's factor against the CPU's
            cap = dispatch[0]["capacity"]
            drops = []
            for rec in dispatch:
                want_d = moe_mod._pack_dispatch(
                    rec["xf"].cpu(), rec["gate_vals"].cpu(),
                    rec["gate_idx"].cpu(), E, rec["capacity"])
                slot, tok_ids = rec["slot"].cpu(), rec["flat_token"].cpu()
                if not (rec["capacity"] == cap
                        and torch.equal(tok_ids, want_d[1])
                        and torch.equal(slot, want_d[2])
                        and torch.equal(slot >= 0, want_d[2] >= 0)):
                    raise AssertionError("mesh dispatch differs from the "
                                         "CPU's _pack_dispatch")
                drops.append(int((slot < 0).sum()))
            del dispatch
            # the MoE layers' device time in the mesh prefill (warm)
            with capturing_moe(None, MOE_SPAN), \
                    profile(activities=acts) as prof:
                prefill()
            moe_ms1 = span_device_ms(prof, MOE_SPAN)
            top1 = top_kernels(prof)
            # prefill walls, unprofiled, in turns: dense, mesh, mesh, dense
            walls = {"dense": [], "mesh": []}
            for arm in ("dense", "mesh", "mesh", "dense"):
                with (use_mesh(None) if arm == "dense"
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    prefill()
                    walls[arm].append((time.perf_counter() - t0) * 1e3)
            # each layer's mesh output against the no-mesh one on its input
            nodrop = dataclasses.replace(cfg, capacity_factor=E / k)
            err = {"a2a": 0.0, "replicated": 0.0}
            for p, (x, y), (xd, yd) in zip(layers, plain, dec_plain):
                seen = []
                with recording_dispatch(seen):
                    got, _ = moe_mod.moe(p, x, nodrop)
                if int((seen[0]["slot"] < 0).sum()):
                    raise AssertionError("a token dropped at E/k")
                got_d, _ = moe_mod.moe(p, xd, cfg, decode=True)
                for path, a, b in (("a2a", got, y), ("replicated", got_d,
                                                     yd)):
                    if not torch.allclose(a.float(), b.float(),
                                          rtol=KERNEL_TOL, atol=KERNEL_TOL):
                        raise AssertionError(
                            f"mesh {path} MoE output off the no-mesh one "
                            f"by {(a.float() - b.float()).abs().max()}")
                    err[path] = max(err[path], (a.float() - b.float())
                                    .abs().max().item())
            peak = torch.cuda.max_memory_allocated() / 2**30
            # int8 compression over the one-rank group, on the card and on
            # the CPU (gloo)
            g = torch.Generator(device="cuda").manual_seed(30)
            grads = tree_map(lambda a: torch.randn(
                a.shape, generator=g, device="cuda"),
                params["stack"]["segments"][0])
            t0 = time.perf_counter()
            red, e1 = compressed_psum_pod(grads, None)
            torch.cuda.synchronize()
            comp_ms = (time.perf_counter() - t0) * 1e3
            gloo = dist.new_group(backend="gloo")
            red_c, e1_c = compressed_psum_pod(
                tree_map(lambda a: a.cpu(), grads), None, group=gloo)
            same = all(torch.equal(a.cpu(), b) for a, b in zip(
                tree_flatten(red) + tree_flatten(e1),
                tree_flatten(red_c) + tree_flatten(e1_c)))
            n_comp = sum(t.numel() for t in tree_flatten(grads))
            del grads, red, e1, red_c, e1_c
            if not same:
                raise AssertionError("compressed_psum_pod on the card "
                                     "differs from the CPU path")
    finally:
        dist.destroy_process_group()
    out = dict(
        tokens=T, capacity=cap, drops_per_layer=drops,
        expert_rows_mesh=E * cap, expert_rows_dense=T * E,
        flash_launches=launches["flash_attention"],
        moe_device_ms_mesh=moe_ms1, moe_device_ms_dense=moe_ms0,
        prefill_wall_ms_mesh=walls["mesh"],
        prefill_wall_ms_dense=walls["dense"],
        top_kernels_mesh=top1, top_kernels_dense=top0,
        max_err_a2a_no_drop=err["a2a"], max_err_replicated=err["replicated"],
        peak_gib=peak, compressed_elements=n_comp,
        compressed_psum_ms=comp_ms,
        seconds=time.perf_counter() - t_start)
    log(f"{cfg.name} mesh prefill of {T} tokens ({card}): capacity {cap} "
        f"(factor {cfg.capacity_factor}), tokens dropped per MoE layer "
        f"{drops} (of {T * k} assignments each), expert rows E·cap "
        f"{E * cap} against T·E {T * E} ({T / cap:.2f}x fewer); MoE layers "
        f"{moe_ms1:.2f} ms device time under the mesh against {moe_ms0:.2f} "
        f"ms without (prefill walls in turns, ms: dense, mesh, mesh, dense "
        f"{walls['dense'][0]:.1f}, {walls['mesh'][0]:.1f}, "
        f"{walls['mesh'][1]:.1f}, {walls['dense'][1]:.1f}); "
        f"{launches['flash_attention']} flash "
        f"launches; each layer's mesh output within KERNEL_TOL of the "
        f"no-mesh one (max abs err: all-to-all at E/k {err['a2a']:.4g}, "
        f"replicated {err['replicated']:.4g}), the dispatch equal to the "
        f"CPU's; compressed_psum_pod on {n_comp:,} elements equal to the "
        f"CPU path; peak {peak:.2f} GiB; {out['seconds']:.1f} s")
    return out


def families(torch, card):
    """Phase 10: deepseek-v2-lite-16b at full width and all 27 layers
    (MLA + MoE) through the engine in the slot, paged and chunked runs,
    its prefill against the plain versions and its decode step profiled,
    then its prefill and a decode step under a 1 x 1 mesh (`moe_mesh`);
    then the GQA families through the default mode, each freed before the
    next.  Returns ({config: launches}, deepseek's decode numbers, the
    mesh readings)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.nn.model import init_params
    t_phase = time.perf_counter()
    cfg = get_config(MLA_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"init_params {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {param_bytes(params) / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    requests = phase3_requests(cfg.vocab)
    n_pages = 8 * -(-SLOT_MAX_SEQ // 16)
    runs, recs = {}, {"slot": {}, "paged": {}}
    runs["slot"] = family_serve(torch, cfg, params, requests,
                                f"{cfg.name} slot engine",
                                record=recs["slot"])
    runs["paged"] = family_serve(torch, cfg, params, requests,
                                 f"{cfg.name} paged engine (page 16)",
                                 record=recs["paged"],
                                 kv_layout="paged", page_size=16,
                                 n_pages=n_pages)
    runs["chunked"] = family_serve(
        torch, cfg, params, requests,
        f"{cfg.name} paged engine, chunks of {CHUNK} under {CHUNK_BUDGET}",
        chunked=True, kv_layout="paged", page_size=16, n_pages=n_pages)
    log(f"{cfg.name}: peak memory over the three runs "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    slot_toks = runs["slot"][0]
    first = {k: sum(v[0][r][0] == slot_toks[r][0] for r in slot_toks)
             for k, v in runs.items()}
    whole = {k: sum(v[0][r] == slot_toks[r] for r in slot_toks)
             for k, v in runs.items()}
    log(f"{cfg.name} against the slot run: first tokens equal {first}, "
        f"whole requests equal {whole} (of {len(requests)})")
    if first["paged"] != len(requests):
        raise AssertionError(f"{cfg.name}: the paged run's first tokens, "
                             f"from the same monolithic prefill, differ")
    parting = mla_parting(torch, cfg, requests,
                          {k: v[0] for k, v in runs.items()}, recs)
    del recs
    # the absorbed decode runs in f64, so the slot and paged
    # runs, which reduce over 552 and 4,480 positions, stay bit for bit
    worst = max(u for u, _, _ in parting["attn_ulps"].values())
    if worst > 1 or whole["paged"] != len(requests):
        raise AssertionError(f"{cfg.name}: slot and paged decodes part "
                             f"(attention {worst} ulps apart, whole "
                             f"requests {whole['paged']})")
    for rid, toks in runs["chunked"][0].items():
        if toks[0] != slot_toks[rid][0]:
            chunk_first_token_tie(torch, cfg, params, rid, requests[rid],
                                  (slot_toks[rid][0], toks[0]))
    err, pinned_err, scale, agree, flips = mla_prefill_vs_plain(
        torch, cfg, params, max((p for p, _, _ in requests), key=len))
    log(f"{cfg.name} prefill of the longest prompt, kernels vs plain: "
        f"logits max abs err {err:.4g} (logit scale {scale:.4g}; expert "
        f"sets differing in {flips:.2%} of (layer, token)), {pinned_err:.4g} "
        f"with the plain run pinned to the kernel run's experts (tolerance "
        f"{LOGIT_TOL:.0%} of the scale; KERNEL_TOL {KERNEL_TOL}), same "
        f"greedy pick {agree}")
    if not pinned_err <= LOGIT_TOL * scale:
        raise AssertionError(f"{cfg.name} prefill logits: kernels and "
                             f"plain versions differ by {pinned_err}")
    decode = mla_decode_profile(torch, cfg, params, requests)
    decode["serve_tok_s"] = {k: v[2] for k, v in runs.items()}
    decode["slot_vs_paged"] = parting
    mesh = moe_mesh(torch, cfg, params, requests, card)
    launches = {MLA_ARCH: {k: v[1] for k, v in runs.items()}}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for name, depth in FAMILY_DEPTHS.items():
        t0 = time.perf_counter()
        fcfg = get_config(name)
        if depth is not None:
            fcfg = dataclasses.replace(fcfg, n_layers=depth)
        fparams = init_params(fcfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        log(f"init_params {name}: {fcfg.n_layers} of "
            f"{get_config(name).n_layers} layers, d_model {fcfg.d_model}, "
            f"{param_bytes(fparams) / 1e9:.2f} GB")
        launches[name] = default_mode(torch, fcfg, fparams)
        del fparams
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{name}: {time.perf_counter() - t0:.1f} s")
    log(f"phase 10 (families): {time.perf_counter() - t_phase:.1f} s")
    return launches, decode, mesh


# ------------------------------------------------------------ phase 11
HYBRID_ARCH = "hymba-1.5b"
XLSTM_ARCH = "xlstm-350m"
LONG_PROMPT = 1536     # > 1024: the SWA layers band, the global ones' flash
HYBRID_MAX_SEQ = 2048  # the slot arena's rows: the long prompt and its tokens
MAMBA_SPAN = "mamba"   # profiler range around each Mamba branch
# hymba's logits amplify rounding more than gemma-7b's, for which LOGIT_TOL
# was set: on the card the plain versions, moved by one bf16 ulp in the
# share of outputs where kernel and plain part (a fifth of them), move the
# long prompt's logits by ~5% of their scale.  So phase 11 measures that
# floor in its own run and holds the kernels' logits to the larger of
# LOGIT_TOL and NOISE_MARGIN x the floor; a wrong kernel (a missed page or
# mask) moves them by their scale
NOISE_MARGIN = 2
# the paged arena's refusal, word for word as the reference words it
PAGED_REFUSAL = ("paged KV needs a pure-attention stack; layer 0 of {name} "
                 "is {kind!r} (use kv_layout='slot')")


def hybrid_requests(vocab):
    """Phase 3's requests, then one prompt of LONG_PROMPT tokens."""
    rng = np.random.default_rng(11)
    return phase3_requests(vocab) + [
        (rng.integers(1, vocab, LONG_PROMPT).tolist(), 16, {})]


def ulp_noise(torch, out, share, gen):
    """`out` (bf16) moved by one ulp, up or down, in a random `share` of
    its elements: rounding noise of a kernel's size."""
    f = out.float()
    ulp = torch.where(f == 0, torch.zeros_like(f),
                      torch.exp2(torch.floor(torch.log2(f.abs())) - 7))
    pick = torch.rand(f.shape, generator=gen, device=f.device) < share
    sign = torch.where(torch.rand(f.shape, generator=gen, device=f.device)
                       < 0.5, -1.0, 1.0)
    return (f + pick * sign * ulp).to(out.dtype)


def attention_wrappers(torch, records=None, noise=None, gen=None):
    """A patch of both attention wrappers.  With `records`: each call runs
    the kernel and its plain version on the same inputs and appends (name,
    max abs err, share of output elements that differ); the kernel's
    output goes on.  With `noise` ({name: share}): the plain versions, each
    output moved by one ulp in that share of its elements (`ulp_noise`)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    from repro_torch.nn import attention as attn_mod

    def wrap(name, kernel, plain):
        def call(*a, **kw):
            ref = plain(*a, **kw)
            if noise is not None:
                return ulp_noise(torch, ref, noise.get(name, 0.0), gen)
            out = kernel(*a, **kw)
            records.append((name, (out.float() - ref.float()).abs().max()
                            .item(), (out != ref).float().mean().item()))
            return out
        return call
    return mock.patch.multiple(
        attn_mod,
        paged_attention=wrap("paged_attention", paged_attention,
                             paged_attention_plain),
        flash_attention=wrap(
            "flash_attention",
            lambda q, k, v, causal: flash_attention(q, k, v, causal=causal),
            lambda q, k, v, causal: flash_attention_plain(q, k, v, causal)))


def state_logits_vs_plain(torch, cfg, params, prompt):
    """`prompt` prefilled into a one-slot arena of HYBRID_MAX_SEQ, its
    prefill logits and one slot decode step (the decode three times on the
    same saved cache: attention rings and recurrent state) run three ways:
    through the kernels, each call also held against its plain version on
    the same inputs (`attention_wrappers` records); through the plain
    versions; and through the plain versions moved by one ulp in the share
    of elements where the kernel and plain version part (the noise floor
    of that rounding in this model).  Returns ({"prefill" | "decode":
    (kernels vs plain, plain vs noisy plain)}, logit scale, same greedy
    picks, the per-call records)."""
    from repro_torch.launch.steps import cached_serve_step, prefill_step
    from repro_torch.serving import KVArena
    from repro_torch.tree import tree_leaves
    batch = {"tokens": torch.tensor([prompt], device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(LONG_PROMPT)
    records = []

    def share(name):
        return statistics.mean(r[2] for r in records if r[0] == name)
    with attention_wrappers(torch, records):
        k_logits, one = prefill_step(params, batch, cfg, HYBRID_MAX_SEQ)
    with plain_attention():
        p_logits, _ = prefill_step(params, batch, cfg, HYBRID_MAX_SEQ)
    with attention_wrappers(torch, noise={"flash_attention":
                                          share("flash_attention")},
                            gen=gen):
        n_logits, _ = prefill_step(params, batch, cfg, HYBRID_MAX_SEQ)
    arena = KVArena(cfg, 1, HYBRID_MAX_SEQ, device="cuda")
    arena.install(arena.alloc(0), one,
                  int(k_logits[0, :cfg.vocab].argmax()), len(prompt))
    saved = [t.clone() for t in tree_leaves(arena.caches)]
    tok, pos = arena.decode_inputs()
    step = cached_serve_step(cfg)

    def decode(patch):
        for t, s_ in zip(tree_leaves(arena.caches), saved):
            t.copy_(s_)
        with patch:
            return step(params, tok, arena.caches, pos)[0]
    k_dec = decode(attention_wrappers(torch, records))
    p_dec = decode(plain_attention())
    n_dec = decode(attention_wrappers(
        torch, noise={"paged_attention": share("paged_attention")},
        gen=gen))
    errs, scale, agree = {}, 0.0, True
    for name, (k, p, n) in (("prefill", (k_logits, p_logits, n_logits)),
                            ("decode", (k_dec, p_dec, n_dec))):
        k32, p32, n32 = (x.float()[:, :cfg.vocab] for x in (k, p, n))
        if not (torch.isfinite(k32).all() and k32.shape == (1, cfg.vocab)):
            raise AssertionError(f"{cfg.name} logits not finite / wrong "
                                 "shape")
        errs[name] = ((k32 - p32).abs().max().item(),
                      (p32 - n32).abs().max().item())
        scale = max(scale, p32.abs().max().item())
        agree = agree and bool(k32.argmax(-1) == p32.argmax(-1))
    del arena, saved
    torch.cuda.empty_cache()
    return errs, scale, agree, records


def mamba_timed(torch):
    """A patch that times every Mamba branch on the host (synchronized on
    both sides) into the returned list, in seconds."""
    from repro_torch.nn import transformer as tf_mod
    spans = []
    orig = tf_mod.mamba

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return out
    return mock.patch.object(tf_mod, "mamba", timed), spans


def hybrid_profile(torch, cfg, params, requests, long_prompt):
    """The first 8 prompts prefilled into a slot arena of HYBRID_MAX_SEQ,
    its batched decode step profiled (wall against device time, the Mamba
    branches' share of device time through a profiler range around each),
    then the long prompt's monolithic prefill wall, with the host time
    spent inside the Mamba branches (its per-token scan loop).  Returns a
    dict of the numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.launch.steps import cached_serve_step, prefill_step
    from repro_torch.nn import transformer as tf_mod
    from repro_torch.serving import KVArena
    arena = KVArena(cfg, 8, HYBRID_MAX_SEQ, device="cuda")
    for rid, (prompt, _, _) in enumerate(requests[:8]):
        logits, one = prefill_step(
            params, {"tokens": torch.tensor([prompt], device="cuda")},
                                   cfg, HYBRID_MAX_SEQ)
        arena.install(arena.alloc(rid), one,
                      int(logits[0, :cfg.vocab].argmax()), len(prompt))
    tok, pos = arena.decode_inputs()
    step = cached_serve_step(cfg)
    weights = param_bytes(params)
    wall_ms = profile_step(
        torch, lambda: step(params, tok, arena.caches, pos), 5,
        f"{cfg.name} slot decode step (8 rows, {cfg.n_layers} layers)",
        weights / HBM_BYTES_PER_S * 1e3)
    orig = tf_mod.mamba

    def spanned(*a, **k):
        with record_function(MAMBA_SPAN):
            return orig(*a, **k)
    with mock.patch.object(tf_mod, "mamba", spanned), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step(params, tok, arena.caches, pos)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    device_ms = sum(e.device_time_total for e in averages
                    if e.device_type == DeviceType.CUDA
                    and e.key != MAMBA_SPAN) / 1e3 / 5
    mamba_ms = max((e.device_time_total for e in averages
                    if e.key == MAMBA_SPAN
                    and e.device_type == DeviceType.CPU),
                   default=0) / 1e3 / 5
    del arena
    torch.cuda.empty_cache()
    batch = {"tokens": torch.tensor([long_prompt], device="cuda")}
    prefill_step(params, batch, cfg, HYBRID_MAX_SEQ)      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_step(params, batch, cfg, HYBRID_MAX_SEQ)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    patch, spans = mamba_timed(torch)
    with patch:
        t0 = time.perf_counter()
        prefill_step(params, batch, cfg, HYBRID_MAX_SEQ)
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t0) * 1e3
    out = dict(decode_wall_ms=wall_ms, decode_device_ms=device_ms,
               decode_mamba_device_ms=mamba_ms,
               decode_weight_bound_ms=weights / HBM_BYTES_PER_S * 1e3,
               decode_tok_s=8 / (wall_ms / 1e3),
               long_prefill_ms=prefill_ms,
               long_prefill_mamba_ms=sum(spans) * 1e3,
               long_prefill_synced_ms=timed_ms)
    share = (f"{mamba_ms / device_ms:.1%}" if mamba_ms and device_ms
             else "not measured")
    log(f"{cfg.name} decode step: Mamba branches {mamba_ms:.2f} ms of "
        f"{device_ms:.2f} ms device time ({share}); {LONG_PROMPT}-token "
        f"prefill {prefill_ms:.1f} ms wall, of which the Mamba branches "
        f"{out['long_prefill_mamba_ms']:.1f} ms ({len(spans)} calls, "
        f"synchronized each; that run {timed_ms:.1f} ms)")
    return out


def recurrent(torch):
    """Phase 11: hymba-1.5b whole at full width (32 layers, weights drawn
    on the card) through the slot engine with phase 3's requests and one
    LONG_PROMPT prompt, its long prompt's prefill and a decode step
    against the plain versions, the paged arena's refusal, the default
    mode and a profiled decode step and long prefill; then xlstm-350m
    whole (24 layers) through the default mode and the slot engine, no
    kernel launched, and the engine's refusal of chunked prefill.  Returns
    ({config: launches}, hymba's profile numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.nn.model import init_params
    from repro_torch.serving import (EngineModel, PagedKVArena,
                                     ServingEngine)
    t_phase = time.perf_counter()
    launches = {}
    cfg = get_config(HYBRID_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"init_params {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {param_bytes(params) / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s; kernel layers (flash, paged) "
        f"{kernel_layers(cfg)}")
    requests = hybrid_requests(cfg.vocab)
    _, slot_launches, tok_s = family_serve(
        torch, cfg, params, requests,
        f"{cfg.name} slot engine ({len(requests)} requests, one of "
        f"{LONG_PROMPT} tokens)", max_seq=HYBRID_MAX_SEQ)
    errs, scale, agree, records = state_logits_vs_plain(
        torch, cfg, params, requests[-1][0])
    for name in ("flash_attention", "paged_attention"):
        calls = [r for r in records if r[0] == name]
        differ = statistics.mean(r[2] for r in calls)
        log(f"{cfg.name} {name} on the long prompt's path, kernel vs plain "
            f"on each call's inputs: {len(calls)} calls, max abs err "
            f"{max(r[1] for r in calls):.4g} (KERNEL_TOL {KERNEL_TOL}), "
            f"output elements that differ {differ:.2%}")
        if not all(r[1] <= KERNEL_TOL for r in calls):
            raise AssertionError(f"{cfg.name}: {name} disagrees with its "
                                 "plain version on the path's inputs")
    for name, (err, floor) in errs.items():
        tol = max(LOGIT_TOL * scale, NOISE_MARGIN * floor)
        log(f"{cfg.name} {LONG_PROMPT}-token prompt {name} logits, kernels "
            f"vs plain: max abs err {err:.4g}; plain vs plain moved by one "
            f"ulp in the share of elements where kernel and plain part (the "
            f"noise floor): {floor:.4g}; logit scale {scale:.4g}; tolerance "
            f"{tol:.4g} (the larger of {LOGIT_TOL:.0%} of the scale and "
            f"{NOISE_MARGIN}x the floor)")
        if not err <= tol:
            raise AssertionError(f"{cfg.name} {name} logits: kernels and "
                                 "plain versions differ beyond the "
                                 "tolerance")
    log(f"{cfg.name}: same greedy picks, kernels vs plain: {agree}")
    for c in (cfg, get_config(XLSTM_ARCH)):
        try:
            PagedKVArena(c, 8, 64, 16, device="cuda")
        except ValueError as e:
            from repro_torch.nn.transformer import layer_kind
            want = PAGED_REFUSAL.format(name=c.name, kind=layer_kind(c, 0))
            if str(e) != want:
                raise AssertionError(f"paged refusal {e!r}, want {want!r}")
        else:
            raise AssertionError(f"the paged arena took {c.name}")
    log(f"paged arena refuses {HYBRID_ARCH} and {XLSTM_ARCH} with the "
        f"reference's message")
    launches[HYBRID_ARCH] = {"slot": slot_launches,
                             "default_mode": default_mode(torch, cfg,
                                                          params)}
    profile = hybrid_profile(torch, cfg, params, requests, requests[-1][0])
    profile["serve_tok_s"] = tok_s
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{cfg.name}: {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    cfg = get_config(XLSTM_ARCH)
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"init_params {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {param_bytes(params) / 1e9:.2f} GB")
    launches[XLSTM_ARCH] = {"default_mode": default_mode(torch, cfg,
                                                         params)}
    _, launches[XLSTM_ARCH]["slot"], _ = family_serve(
        torch, cfg, params, phase3_requests(cfg.vocab),
        f"{cfg.name} slot engine")
    try:
        ServingEngine([EngineModel(cfg.name, params, cfg)],
                      prefill_chunk=CHUNK, device="cuda")
    except ValueError as e:
        if "mLSTM" not in str(e):
            raise
        log(f"{cfg.name}: the engine refuses prefill_chunk {CHUNK}: {e}")
    else:
        raise AssertionError(f"{cfg.name}: the engine took chunked prefill")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{cfg.name}: {time.perf_counter() - t0:.1f} s")
    log(f"phase 11 (hybrid and xLSTM): {time.perf_counter() - t_phase:.1f} s")
    return launches, profile


# ------------------------------------------------------------ phase 12
ENCODER_ARCH = "hubert-xlarge"
VLM_ARCH = "paligemma-3b"
ENCODER_DATA = (1500, 4)       # (seq_len, batch): 30 s clips at 50 frames/s
# paligemma's default mode: 32 text tokens behind 256 image positions (a
# prefill of S 288, a slot of 304 = 288 + 16)
VLM_GREEDY = dict(smoke=False, batch=4, prompt_len=32, gen=16)
VLM_LONG_PROMPT = 1024         # + 256 image positions: past the masked
                               # softmax's 1,024, so `chunked_attention`


def encoder_forward(torch, cfg, params):
    """hubert-xlarge's forward over `make_batch`'s ENCODER_DATA embeddings
    batch (warmed once, then launch counts set to 0 just before and read
    just after: one non-causal flash launch a layer, no paged), its logits
    through the kernels against the plain versions within the larger of
    LOGIT_TOL and NOISE_MARGIN x the noise floor the run measures (phase
    11's `attention_wrappers`; each kernel call also held against its
    plain version on its inputs), and the forward profiled (wall against
    device time) beside its bound.  Returns a dict of the numbers."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.nn.model import forward
    from repro_torch.tree import tree_leaves
    S, B = ENCODER_DATA
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in make_batch(cfg, DataConfig(S, B), 0).items()}
    forward(params, batch, cfg)                  # warm
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    logits, caches, _ = forward(params, batch, cfg)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention": flash_attention.launches,
                "paged_attention": paged_attention.launches}
    want = {"flash_attention": cfg.n_layers, "paged_attention": 0}
    if launches != want or caches is not None \
            or logits.shape != (B, S, cfg.vocab_padded) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name} forward: launches {launches}, "
                             f"want {want}; logits {tuple(logits.shape)}")
    records = []
    with attention_wrappers(torch, records):
        k_logits = forward(params, batch, cfg)[0]
    with plain_attention():
        p_logits = forward(params, batch, cfg)[0]
    differ = statistics.mean(r[2] for r in records)
    with attention_wrappers(torch, noise={"flash_attention": differ},
                            gen=torch.Generator(device="cuda")
                            .manual_seed(S)):
        n_logits = forward(params, batch, cfg)[0]
    k32, p32, n32 = (x.float()[..., :cfg.vocab]
                     for x in (k_logits, p_logits, n_logits))
    err = (k32 - p32).abs().max().item()
    floor = (p32 - n32).abs().max().item()
    scale = p32.abs().max().item()
    tol = max(LOGIT_TOL * scale, NOISE_MARGIN * floor)
    agree = (k32.argmax(-1) == p32.argmax(-1)).float().mean().item()
    call_err = max(r[1] for r in records)
    log(f"{cfg.name} forward ({B} x {S} frames, {cfg.n_layers} layers): "
        f"{wall_ms:.1f} ms wall, launches {json.dumps(launches)}; flash on "
        f"the path, kernel vs plain on each call's inputs: {len(records)} "
        f"calls, max abs err {call_err:.4g} (KERNEL_TOL {KERNEL_TOL}), "
        f"output elements that differ {differ:.2%}; logits kernels vs "
        f"plain max abs err {err:.4g}, noise floor {floor:.4g}, logit scale "
        f"{scale:.4g}, tolerance {tol:.4g}; argmax agreement {agree:.4f}")
    if not (call_err <= KERNEL_TOL and err <= tol):
        raise AssertionError(f"{cfg.name} forward: kernels and plain "
                             "versions differ beyond the tolerance")
    del k_logits, p_logits, n_logits, k32, p32, n32
    # compute: 2 flops a weight a frame, Q·Kᵀ and P·V over S x S a head;
    # memory: every weight read once
    weights = sum(t.numel() for t in tree_leaves(params["stack"])) + \
        params["embedding"]["head"].numel()
    n_flops = 2 * weights * B * S + 4 * B * S * S * cfg.q_dim * cfg.n_layers
    bound = bound_ms(param_bytes(params), n_flops)
    prof_wall = profile_step(
        torch, lambda: forward(params, batch, cfg), 3,
        f"{cfg.name} forward profiled ({B} x {S} frames)", bound[0],
        f"bound by {bound[1]}")
    flash = check_flash(torch, S=S, H=cfg.n_heads, D=cfg.head_dim, seed=S,
                        Hkv=cfg.n_kv_heads, B=B, causal=False)
    f_err, ms, plain_ms, lib_ms, (b, by) = flash
    log(f"flash_attention B{B} S{S} H{cfg.n_heads} D{cfg.head_dim} full "
        f"({cfg.name}, D zero-padded to 128): err {f_err:.3g}, {ms:.4f} ms "
        f"(plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, kernel/sdpa "
        f"{ms / lib_ms:.2f}), bound {b:.4f} ms by {by}, kernel/bound "
        f"{ms / b:.2f}")
    del batch, logits
    return dict(launches=launches, wall_ms=wall_ms, profiled_wall_ms=prof_wall,
                logit_err=err, noise_floor=floor, logit_scale=scale,
                bound_ms=bound[0], bound_by=bound[1], flash=flash)


def vlm_long_prefill(torch, cfg, params):
    """One B 1 prefill of VLM_LONG_PROMPT tokens behind paligemma's image
    positions (S + P past 1,024): every layer through `chunked_attention`
    with the prefix term, no kernel launched (counts set to 0 just before,
    read just after), finite logits and a cache of S + P; the first
    layer's `chunked_attention` held against the masked softmax with the
    same prefix mask within F32_TOL; the prefill timed warm.  Returns
    (launches, ms, the chunked-vs-masked error)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.launch.steps import prefill_step
    from repro_torch.nn import attention as attn_mod
    P = cfg.prefix_len
    L = VLM_LONG_PROMPT + P
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in make_batch(
        cfg, DataConfig(VLM_LONG_PROMPT, 1), 0).items()}
    calls = []
    orig = attn_mod.chunked_attention

    def recording(q, k, v, **kw):
        if not calls:
            calls.append((q.clone(), k.clone(), v.clone(), kw))
        calls.append(kw["prefix_len"])
        return orig(q, k, v, **kw)
    zero_launch_counts()
    with mock.patch.object(attn_mod, "chunked_attention", recording):
        logits, caches = prefill_step(params, batch, cfg, L)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "paged_attention": paged_attention.launches}
    k_shape = tuple(caches[0]["attn"]["k"].shape)
    if launches != {"flash_attention": 0, "paged_attention": 0} \
            or calls[1:] != [P] * cfg.n_layers \
            or logits.shape != (1, cfg.vocab_padded) \
            or not torch.isfinite(logits).all() or k_shape[-4] != 1 \
            or k_shape[-3] != L:
        raise AssertionError(f"{cfg.name} long prefill: launches "
                             f"{launches}, chunked calls {calls[1:]}, "
                             f"logits {tuple(logits.shape)}, cache {k_shape}")
    q, k, v, kw = calls[0]
    pos = torch.arange(L, device="cuda")[None, :]
    mask = attn_mod._mask(pos, pos, causal=True, window=0, prefix_len=P)
    err = (orig(q, k, v, **kw)
           - attn_mod._softmax_attend(q, k, v, mask, 0.0)).abs().max().item()
    if not err <= F32_TOL:
        raise AssertionError(f"{cfg.name}: chunked_attention with the prefix "
                             f"term parts from the masked softmax: {err}")
    del calls, q, k, v, mask, caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_step(params, batch, cfg, L)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    log(f"{cfg.name} prefill 1 x ({P} image + {VLM_LONG_PROMPT} text) "
        f"positions: {ms:.1f} ms wall (warm), launches "
        f"{json.dumps(launches)}, {cfg.n_layers} chunked_attention calls "
        f"with prefix {P}; layer 0's chunked_attention vs the masked "
        f"softmax with the prefix mask: max abs err {err:.3g} (F32_TOL "
        f"{F32_TOL})")
    return launches, ms, err


def input_modes(torch, card):
    """Phase 12: hubert-xlarge whole at full width (48 layers, weights
    drawn on the card) through `encoder_forward`, then paligemma-3b whole
    (18 layers) through the default mode at VLM_GREEDY (paged launches a
    decode step, none of flash; every step against the plain versions)
    and `vlm_long_prefill`, and the paged kernel timed at its slot decode
    shape (B 4, Hkv 1, G 8, D 256 over the 304-token slot seen as 19
    pages of 16, every row at the loop's last position), each model freed
    before the next.  Returns ({config: {run: launches}}, hubert's
    numbers, the paged check)."""
    from repro_torch.configs import get_config
    from repro_torch.nn.attention import _page_view
    from repro_torch.nn.model import init_params
    t_phase = time.perf_counter()
    launches = {}
    cfg = get_config(ENCODER_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"init_params {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {param_bytes(params) / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    encoder = encoder_forward(torch, cfg, params)
    launches[ENCODER_ARCH] = {"forward": encoder.pop("launches")}
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"init_params {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {param_bytes(params) / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s; kernel layers (flash, paged) "
        f"{kernel_layers(cfg)}")
    launches[VLM_ARCH] = {"default_mode": default_mode(torch, cfg, params,
                                                       VLM_GREEDY)}
    launches[VLM_ARCH]["long_prefill"], _, _ = vlm_long_prefill(
        torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    slot = VLM_GREEDY["prompt_len"] + cfg.prefix_len + VLM_GREEDY["gen"]
    page = _page_view(slot)            # the slot decode's view of its cache
    last = slot - 2                    # the loop's last decode position
    paged = check_paged(torch, B=VLM_GREEDY["batch"], H=cfg.n_heads,
                        Hkv=cfg.n_kv_heads, D=cfg.head_dim, page=page,
                        T=slot // page, seed=slot,
                        pos_list=[last] * VLM_GREEDY["batch"])
    err, ms, plain_ms, sdpa_ms, (b, by), warm_ms = paged
    log(f"paged_attention B{VLM_GREEDY['batch']} H{cfg.n_heads} "
        f"Hkv{cfg.n_kv_heads} G{cfg.n_heads // cfg.n_kv_heads} "
        f"D{cfg.head_dim} page{page} T{slot // page} ({cfg.name}'s "
        f"{slot}-token slot, pos {last}): err {err:.3g}, {ms:.4f} ms cold, "
        f"{warm_ms:.4f} ms back to back (plain {plain_ms:.4f} ms, sdpa over "
        f"pre-gathered K/V {sdpa_ms:.4f} ms cold), bound {b:.4f} ms by "
        f"{by}, kernel/bound {ms / b:.2f}")
    log(f"phase 12 (input modes): {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    return launches, encoder, paged


# ------------------------------------------------------------ phase 13
PAPER_SAMPLES = 1_000_000      # synth_layer_codes' default max_samples
PAPER_VARIANTS = ("naive", "baseline", "B", "BR", "BRW")
# BRW/baseline makespan and the §V-C center of each net: model outputs of
# the paper's simulated ARAS machine, as the reference computes them from
# the same seeded codes at PAPER_SAMPLES (the speedup to two decimals)
PAPER_EXPECTED = {"vgg16": (1.84, 104), "resnet50": (2.19, 104),
                  "densenet161": (1.82, 88), "bert_base": (1.00, 152),
                  "bert_large": (1.00, 104)}
PULSE_NETS = ("resnet50", "bert_large")
PULSE_Z_MAX = 6.0              # standard errors from the §V-C expectation
EXAMPLE_ARMS = ("quickstart_torch", "schedule_explore_torch",
                "serve_stream_torch")
SERVE_STREAM_KERNELS = ("paged_attention", "flash_attention", "delta_apply",
                        "pulse_count")


def paper_results(graph, codes, walls=None):
    """Everything the paper layer computes for one net from its codes:
    `simulate_aras` in the five variants, `simulate_tpu`,
    `upper_bound_cycles` and the BRW schedule with `validate_schedule`'s
    findings, as plain values (instructions and bank plans as tuples).
    Appends each `simulate_aras` call's host wall to `walls`."""
    import dataclasses
    from repro_torch.core.resources import AcceleratorConfig
    from repro_torch.core.scheduler import build_schedule, validate_schedule
    from repro_torch.sim.aras import (ArasSimConfig, simulate_aras,
                                      upper_bound_cycles)
    from repro_torch.sim.tpu import simulate_tpu

    def fields(r):
        out = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
        out["instructions"] = [dataclasses.astuple(i)
                               for i in r.instructions]
        return out

    out = {}
    for v in PAPER_VARIANTS:
        t0 = time.perf_counter()
        r = simulate_aras(graph, codes, ArasSimConfig.variant(v))
        if walls is not None:
            walls.append(time.perf_counter() - t0)
        out[v] = fields(r)
    out["tpu"] = dataclasses.asdict(simulate_tpu(graph))
    out["upper_bound_cycles"] = upper_bound_cycles(graph, AcceleratorConfig())
    sched = build_schedule(graph, codes, ArasSimConfig.variant("BRW"))
    out["schedule"] = {
        "encodings": [(e.name, e.offset, e.clip_rate, e.hist.tolist())
                      for e in sched.encodings],
        "reuse_center": sched.reuse_center,
        "bank_plan": {k: dataclasses.astuple(b)
                      for k, b in sched.bank_plan.items()},
        "predicted": fields(sched.predicted),
        "errors": validate_schedule(sched)}
    return out


def hist_pass_ms(torch, codes):
    """Device time of one histogram pass over a net's codes: the 256-bin
    `bincount` of every layer, as `encode_network` counts them."""
    return cuda_ms(lambda: [torch.bincount(c.reshape(-1), minlength=256)
                            for _, c in codes], 3)


def pulses_vs_expectation(torch, codes, encodings):
    """13b: for each pair of consecutive layers (a, b) under BRW, the
    first min(n_a, n_b) codes of each shifted by its layer's offset with
    the reference's clip, b's overwriting a's.  The pulse_count kernel's
    totals must equal the plain version's.  Returns, for every pair,
    (|z|, z, pair, n, pulses per weight, expected): z is the distance of
    pulses per weight from `expected_pulses_per_weight` of the two
    layers' histograms in standard errors (the per-weight sample standard
    deviation over sqrt(n)); the caller holds |z| to PULSE_Z_MAX."""
    from repro_torch.core.weight_reuse import expected_pulses_per_weight
    from repro_torch.kernels.pulse_count.ops import pulse_count
    from repro_torch.kernels.pulse_count.ref import pulse_count_plain
    from repro_torch.xbar.cells import cell_deltas

    def shifted(c, off):
        return torch.clamp(c.to(torch.int16) + off, 0, 255).to(torch.uint8)

    zs = []
    for (name_a, a), (name_b, b), ea, eb in zip(
            codes[:-1], codes[1:], encodings[:-1], encodings[1:]):
        n = min(a.numel(), b.numel())
        old = shifted(a, ea.offset)[:n].contiguous()
        new = shifted(b, eb.offset)[:n].contiguous()
        got = [int(t) for t in pulse_count(old, new)]
        want = [int(t) for t in pulse_count_plain(old, new)]
        if got != want:
            raise AssertionError(f"pulse_count {name_a} -> {name_b}: kernel "
                                 f"{got} vs plain {want}")
        per_weight = cell_deltas(old, new).abs().sum(-1, dtype=torch.float64)
        if int(per_weight.sum()) != got[0]:
            raise AssertionError(f"pulse_count {name_a} -> {name_b}: total "
                                 f"{got[0]} vs per-weight sum")
        se = per_weight.std().item() / n ** 0.5
        expected = expected_pulses_per_weight(ea.hist, eb.hist)
        z = (got[0] / n - expected) / se
        zs.append((abs(z), z, f"{name_a} -> {name_b}", n, got[0] / n,
                   expected))
    return zs


def run_example(torch, name):
    """Load examples/<name>.py by path, run its main() on the card with
    the launch counts zeroed just before, and log what it prints.
    Returns (launches, seconds)."""
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    zero_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        module.main("cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    for line in buf.getvalue().splitlines():
        log(f"  {name}| {line}")
    log(f"{name}: {seconds:.1f} s, launches {json.dumps(launches)}")
    return launches, seconds


def paper_layer(torch, card):
    """Phase 13: the ARAS paper layer.  (a) each of the five paper nets
    with its seeded codes at PAPER_SAMPLES on the card through the five
    variants, the TPU-like baseline, the upper bound and the BRW schedule
    (which must validate), every result equal to the same calls with the
    codes on the CPU, the speedup and center as PAPER_EXPECTED; (b)
    `pulses_vs_expectation` on PULSE_NETS; (c) the three example arms in
    this process.  Returns ({run: launches}, numbers for the log)."""
    from repro_torch.core.weight_reuse import encode_network
    from repro_torch.models import PAPER_NETS, build_net, synth_layer_codes
    t_phase = time.perf_counter()
    launches, summary, kept = {}, {}, {}
    zero_launch_counts()
    for name in PAPER_NETS:
        graph = build_net(name)
        t0 = time.perf_counter()
        codes = synth_layer_codes(graph, max_samples=PAPER_SAMPLES,
                                  device="cuda")
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        walls = []
        got = paper_results(graph, codes, walls)
        plain = paper_results(graph, [(n, c.cpu()) for n, c in codes])
        for key in plain:
            if got[key] != plain[key]:
                raise AssertionError(f"{name}: {key} with the codes on the "
                                     f"card differs from the CPU path's")
        if got["schedule"]["errors"]:
            raise AssertionError(f"{name}: invalid BRW schedule: "
                                 f"{got['schedule']['errors'][:3]}")
        base, brw = got["baseline"], got["BRW"]
        speedup = base["makespan_s"] / brw["makespan_s"]
        center = brw["reuse_center"]
        if (round(speedup, 2), center) != PAPER_EXPECTED[name]:
            raise AssertionError(f"{name}: speedup {speedup:.4f}, center "
                                 f"{center}; expected {PAPER_EXPECTED[name]}")
        hist_ms = hist_pass_ms(torch, codes)
        n_codes = sum(c.numel() for _, c in codes)
        summary[name] = {
            "layers": len(graph), "weights": graph.total_weights,
            "codes": n_codes,
            "makespan_ms_model": {v: got[v]["makespan_s"] * 1e3
                                  for v in PAPER_VARIANTS},
            "speedup_brw_vs_baseline": speedup,
            "pulse_ratio": brw["total_pulses"] / base["total_pulses"],
            "energy_ratio": brw["energy"]["total"] / base["energy"]["total"],
            "center": center,
            "tpu_vs_brw_makespan": got["tpu"]["makespan_s"]
            / brw["makespan_s"],
            "upper_bound_ms_model": got["upper_bound_cycles"] / 1e6,
            "simulate_aras_wall_s": walls, "draw_s": draw_s,
            "hist_pass_device_ms": hist_ms}
        log(f"{name}: {len(graph)} layers, {graph.total_weights / 1e6:.1f}M "
            f"weights, {n_codes:,} codes on the card; model makespans (ms, "
            f"simulated ARAS) " + ", ".join(
                f"{v} {got[v]['makespan_s'] * 1e3:.4f}"
                for v in PAPER_VARIANTS)
            + f"; BRW/baseline speedup {speedup:.4f}, pulses "
            f"{summary[name]['pulse_ratio']:.4f}, energy "
            f"{summary[name]['energy_ratio']:.4f}, center {center}, "
            f"TPU-like/BRW makespan "
            f"{summary[name]['tpu_vs_brw_makespan']:.4f}; host wall per "
            f"simulate_aras {statistics.mean(walls):.4f} s (max "
            f"{max(walls):.4f}), histogram pass {hist_ms:.4f} ms device "
            f"time, draw {draw_s:.2f} s; equal to the CPU path")
        if name in PULSE_NETS:
            kept[name] = codes
    launches["nets"] = launch_counts()

    zero_launch_counts()
    zs = []
    for name in PULSE_NETS:
        encodings, _ = encode_network(kept[name])
        zs += pulses_vs_expectation(torch, kept[name], encodings)
    launches["pulse_vs_expectation"] = launch_counts()
    worst = max(zs)
    log(f"pulse_count vs expected_pulses_per_weight over {len(zs)} "
        f"consecutive pairs of {' and '.join(PULSE_NETS)} (BRW offsets): "
        f"kernel equal to plain on every pair; largest |z| {worst[0]:.3f} "
        f"at {worst[2]} (n {worst[3]:,}, {worst[4]:.5f} pulses/weight vs "
        f"{worst[5]:.5f} expected); mean |z| "
        f"{statistics.mean(z[0] for z in zs):.3f}; launches "
        f"{json.dumps(launches['pulse_vs_expectation'])}")
    if worst[0] > PULSE_Z_MAX:
        raise AssertionError(f"pulse_count: {worst[2]} lies {worst[0]:.2f} "
                             f"standard errors from the expectation")
    if launches["pulse_vs_expectation"]["pulse_count"] != len(zs):
        raise AssertionError(f"pulse_count: {len(zs)} pairs but "
                             f"{launches['pulse_vs_expectation']} launches")
    del kept
    summary["pulse_z"] = {"pairs": len(zs), "max_abs_z": worst[0],
                          "at": worst[2]}

    for name in EXAMPLE_ARMS:
        launches[name], summary[f"{name}_s"] = run_example(torch, name)
    missing = [k for k in SERVE_STREAM_KERNELS
               if not launches["serve_stream_torch"][k]]
    if missing:
        raise AssertionError(f"serve_stream_torch launched no {missing}")
    log(f"phase 13 (ARAS paper layer): {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    return launches, summary



# ------------------------------------------------------------ phase 14
TRAIN_ARCH = "minicpm-2b"
TRAIN_B, TRAIN_S = 4, 2048     # the CLI's --batch and --seq at full width
TRAIN_STEPS = 3
# the Function's gradients are bf16 like its inputs: each of dq, dk, dv
# within KERNEL_TOL of the plain route's, relative to its largest element
GRAD_TOL = KERNEL_TOL
# a whole model's gradient, kernels against plain versions: every leaf
# within the CPU parity tests' 3e-2 in relative norm
LEAF_TOL = 3e-2
TRAIN_DIR = os.path.join(ROOT, "build", "phase14")
# Adam's first updates move every weight by about the lr; at full width
# and with no warmup, the CLI's 3e-4 overshoots on one batch (this check
# saw 11.88 -> 12.64 -> 20.39 there) and 1e-5 falls (11.88 -> 10.20 ->
# 9.00).  The reference overshoots too: tests/train_lr_study.py runs both
# packages at minicpm-2b's widths (4 layers, vocab 8,192) on the CPU, and
# at 3e-4 both rise (9.195 -> 13.81 -> 12.28), at 1e-5 both fall
FALL_LR = 1e-5


def train_lines(out):
    """{step: (loss, ce, gnorm, lr string, ms)} from the trainer's lines."""
    rx = re.compile(r"step\s+(\d+) loss=(\S+) ce=(\S+) gnorm=(\S+) "
                    r"lr=(\S+)\s+(\S+) ms")
    return {int(m.group(1)): (float(m.group(2)), float(m.group(3)),
                              float(m.group(4)), m.group(5),
                              float(m.group(6)))
            for m in rx.finditer(out)}


def run_trainer(*argv):
    """`python -m repro_torch.launch.train` in this process (so its
    launches are counted here); returns its standard output."""
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(list(argv))
    return buf.getvalue()


def check_function(torch, B=TRAIN_B, S=TRAIN_S, H=36, D=64, seed=14):
    """The training attention Function at minicpm-2b's shape (G 1, causal):
    the kernel route's o, lse, dq, dk and dv against a plain route
    (autograd through the plain version; its logsumexp), then the times
    of the kernel forward with and without lse, the torch-op backward,
    the plain route and SDPA forward + backward, and the backward's
    bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.nn.flash import flash_attention_train, flash_backward
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_attention.launches
    o = flash_attention_train(*leaves, True)
    o.backward(do)
    if flash_attention.launches != before + 1:
        raise AssertionError("the Function's forward is not one launch")
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o_p = flash_attention_plain(*plain, True)
    o_p.backward(do)
    _, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    _, lse_p = flash_attention_plain(q, k, v, True, return_lse=True)
    errs = {"o": (o.float() - o_p.float()).abs().max().item(),
            "lse": (lse - lse_p).abs().max().item()}
    for name, a, b in zip(("dq", "dk", "dv"), leaves, plain):
        scale = max(1.0, b.grad.float().abs().max().item())
        errs[name] = (a.grad.float() - b.grad.float()).abs().max().item() \
            / scale
        if a.grad.dtype != torch.bfloat16:
            raise AssertionError(f"{name} is {a.grad.dtype}")
    if not (errs["o"] <= KERNEL_TOL and errs["lse"] <= LSE_TOL and
            max(errs[n] for n in ("dq", "dk", "dv")) <= GRAD_TOL):
        raise AssertionError(f"the Function disagrees with the plain route "
                             f"at B{B} S{S} H{H} D{D}: {errs}")
    o_k, lse_k = flash_attention(q, k, v, causal=True, return_lse=True)
    fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 10)
    lse_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                             return_lse=True), 10)
    bwd_ms = cuda_ms(lambda: flash_backward(q, k, v, o_k, lse_k, do, True),
                     3)

    def plain_fwd_bwd():
        x = [t.detach().requires_grad_(True) for t in (q, k, v)]
        flash_attention_plain(*x, True).backward(do)

    def sdpa_fwd_bwd():
        x = [t.detach().transpose(1, 2).requires_grad_(True)
             for t in (q, k, v)]
        F.scaled_dot_product_attention(*x, is_causal=True).backward(
            do.transpose(1, 2))

    plain_ms = cuda_ms(plain_fwd_bwd, 3)
    sdpa_ms = cuda_ms(sdpa_fwd_bwd, 10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 10)
    pairs = S * (S + 1) // 2
    fwd_bound = bound_ms(4 * B * S * H * D * 2, 4 * B * H * D * pairs)
    # read q, k, v, o, do and lse once, write dq, dk, dv; five products
    # over the causal pairs (s recomputed, dv, dp, dk, dq)
    n_bytes = 8 * B * S * H * D * 2 + B * H * S * 4
    bound = bound_ms(n_bytes, 10 * B * H * D * pairs)
    log(f"training Function B{B} S{S} H{H} D{D} causal: errs "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}; "
        f"kernel forward {fwd_ms:.4f} ms, with lse {lse_ms:.4f} ms (SDPA "
        f"forward {sdpa_fwd_ms:.4f} ms, bound {fwd_bound[0]:.4f} ms by "
        f"{fwd_bound[1]}); torch-op "
        f"backward {bwd_ms:.4f} ms (bound {bound[0]:.4f} ms by {bound[1]} "
        f"at the bf16 rate, backward/bound {bwd_ms / bound[0]:.1f}); plain "
        f"route forward + backward {plain_ms:.4f} ms; SDPA forward + "
        f"backward {sdpa_ms:.4f} ms")
    return {"errs": errs, "fwd_ms": fwd_ms, "lse_ms": lse_ms,
            "fwd_bound": fwd_bound, "sdpa_fwd_ms": sdpa_fwd_ms,
            "bwd_ms": bwd_ms, "bwd_bound": bound, "plain_ms": plain_ms,
            "sdpa_fwd_bwd_ms": sdpa_ms}


def train_cli(torch, cfg):
    """TRAIN_STEPS steps of the trainer CLI at full width, counts zeroed
    just before: loss finite and in (0.2 ln V, 3 ln V), gnorm finite and
    positive, lr the WSD schedule's, 2 flash launches a layer a step (the
    forward and its remat recompute) and no other kernel."""
    from repro_torch.optim import wsd
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = run_trainer("--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                      "--batch", str(TRAIN_B), "--seq", str(TRAIN_S))
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for line in out.splitlines():
        log(f"  {line}")
    lines = train_lines(out)
    if sorted(lines) != list(range(TRAIN_STEPS)) or "done" not in out:
        raise AssertionError(f"trainer printed {sorted(lines)}")
    ln_v = math.log(cfg.vocab)
    total = 100_000            # make_train_step's default, as the CLI's
    for step, (loss, ce, gnorm, lr, _) in lines.items():
        want_lr = float(wsd(step, peak_lr=3e-4, warmup=2000,
                            stable=int(total * 0.8), decay=int(total * 0.1)))
        if not (math.isfinite(loss) and 0.2 * ln_v < loss < 3 * ln_v
                and math.isfinite(gnorm) and gnorm > 0
                and lr == f"{want_lr:.2e}"):
            raise AssertionError(f"step {step}: loss {loss}, gnorm {gnorm}, "
                                 f"lr {lr} (want {want_lr:.2e})")
    want = {k: 0 for k in launches}
    want["flash_attention"] = 2 * cfg.n_layers * TRAIN_STEPS
    if launches != want:
        raise AssertionError(f"trainer launches {launches}, want {want}")
    walls = [lines[s][4] for s in sorted(lines)]
    log(f"trainer {TRAIN_ARCH} B{TRAIN_B} S{TRAIN_S}: step walls "
        f"{walls} ms ({TRAIN_B * TRAIN_S / walls[-1] * 1e3:.0f} tokens/s at "
        f"the last), peak memory {peak / 2**30:.2f} GiB, launches "
        f"{json.dumps(launches)}")
    return launches, walls, peak


def train_params(torch, cfg):
    from repro_torch.launch.train import cast_for_training
    from repro_torch.nn.model import init_params
    return cast_for_training(init_params(cfg, seed=0, device="cuda"))


def train_batch(torch, cfg, step=0):
    from repro_torch.data.pipeline import DataConfig, make_batch
    nb = make_batch(cfg, DataConfig(seq_len=TRAIN_S, global_batch=TRAIN_B),
                    step)
    return {k: torch.as_tensor(v, device="cuda") for k, v in nb.items()}


def loss_falls(torch, cfg, params, batch):
    """make_train_step(warmup=1) for TRAIN_STEPS updates on one repeated
    batch (steps 1.. at the peak lr, FALL_LR): the loss must fall at every
    step.  Each step timed (wall, ending in a synchronize), and the last
    one profiled: its device time and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import tree_flatten, tree_map
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, peak_lr=FALL_LR, warmup=1)
    losses, walls = [], []
    for step in range(1, TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step < TRAIN_STEPS:
            params, opt, m = step_fn(params, opt, batch, step)
            losses.append(float(m["loss"]))
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                params, opt, m = step_fn(params, opt, batch, step)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    device_ms = _device_busy_s(prof) * 1e3
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"make_train_step on one batch: losses "
                             f"{losses} do not fall")
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    log(f"make_train_step {TRAIN_ARCH} on one batch: losses {losses}; step "
        f"walls {[f'{w:.1f}' for w in walls]} ms (the last profiled), its "
        f"device busy {device_ms:.1f} ms ({device_ms / walls[-1]:.1%})")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        log(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
            f"{e.key[:90]}")
    # the optimizer alone: one AdamW update of every leaf (zero gradients
    # do the same work), device time by CUDA events
    grads = tree_map(torch.zeros_like, params)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    adamw_update(params, grads, opt, 0.0)
    end.record()
    torch.cuda.synchronize()
    opt_ms, opt_wall = start.elapsed_time(end), (time.perf_counter() - t0) * 1e3
    del grads
    # read p, g, m, v once, write p, m, v: 2 + 2 + 4 + 4 + 2 + 4 + 4 bytes
    # an element (the 1-D f32 leaves are a rounding error)
    n = sum(t.numel() for t in tree_flatten(params))
    opt_bound = bound_ms(22 * n, 0)
    log(f"AdamW alone over {n:,} params: {opt_ms:.1f} ms device, "
        f"{opt_wall:.1f} ms wall (bound {opt_bound[0]:.2f} ms by "
        f"{opt_bound[1]})")
    return {"losses": losses, "walls_ms": walls, "device_ms": device_ms,
            "adamw_ms": opt_ms, "adamw_bound_ms": opt_bound[0]}


def grads_vs_plain(torch, cfg, params, batch):
    """lm_loss and its gradient in every leaf through the kernels, then
    with the training attention swapped for autograd through the plain
    version, on the same params (the seeded init) and batch: the losses,
    and every leaf within LEAF_TOL in relative norm."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.nn import attention as attn_mod
    from repro_torch.nn.model import lm_loss
    from repro_torch.tree import tree_flatten
    leaves = tree_flatten(params)

    def loss_and_grads():
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = lm_loss(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return float(loss.detach()), grads

    loss_k, g_k = loss_and_grads()
    with mock.patch.object(attn_mod, "flash_attention_train",
                           lambda q, k, v, causal: flash_attention_plain(
                               q, k, v, causal)):
        loss_p, g_p = loss_and_grads()
    rel = [((a.float() - b.float()).norm() / b.float().norm().clamp_min(
        1e-30)).item() for a, b in zip(g_k, g_p)]
    gn_k = math.sqrt(sum(float(g.float().square().sum()) for g in g_k))
    gn_p = math.sqrt(sum(float(g.float().square().sum()) for g in g_p))
    log(f"one step's loss and gradient, kernels vs plain: loss {loss_k:.6f} "
        f"vs {loss_p:.6f}, grad norm {gn_k:.6f} vs {gn_p:.6f}, worst leaf "
        f"relative norm {max(rel):.3g} (tolerance {LEAF_TOL})")
    if not (abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
            and max(rel) <= LEAF_TOL):
        raise AssertionError("training step: kernels and plain versions "
                             "differ")
    return {"loss": (loss_k, loss_p), "grad_norm": (gn_k, gn_p),
            "worst_leaf_rel": max(rel)}


def smoke_resume(torch):
    """The trainer at smoke size on the card: 4 steps uninterrupted, and 2
    steps, a checkpoint and a resume to 4; the resumed steps' lines equal
    the uninterrupted run's (the ms column aside)."""
    import shutil
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    argv = ("--arch", TRAIN_ARCH, "--smoke", "--batch", "2", "--seq", "64")
    whole = run_trainer(*argv, "--steps", "4", "--ckpt-dir",
                        os.path.join(TRAIN_DIR, "whole"), "--ckpt-every", "2")
    cut = os.path.join(TRAIN_DIR, "cut")
    run_trainer(*argv, "--steps", "2", "--ckpt-dir", cut)
    resumed = run_trainer(*argv, "--steps", "4", "--ckpt-dir", cut)
    a, b = train_lines(whole), train_lines(resumed)
    if ("resumed from step 2" not in resumed or sorted(b) != [2, 3]
            or any(a[s][:4] != b[s][:4] for s in b)):
        raise AssertionError(f"resume on the card: {whole!r} vs {resumed!r}")
    log(f"smoke checkpoint resume on the card: steps 2-3 "
        f"{[b[s][:4] for s in (2, 3)]} equal the uninterrupted run's")
    # the checkpoint alone: the smoke trainer state saved (blocking) and
    # restored onto the card
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_flatten
    params = train_params(torch, get_config(TRAIN_ARCH, smoke=True))
    state = {"params": params, "opt": adamw_init(params)}
    n_bytes = sum(t.numel() * t.element_size() for t in tree_flatten(state))
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(TRAIN_DIR, "timed"), 1, state)
    t1 = time.perf_counter()
    restore_checkpoint(os.path.join(TRAIN_DIR, "timed"), 1, state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"checkpoint of the smoke trainer state ({n_bytes / 2**20:.1f} MiB, "
        f"{len(tree_flatten(state))} leaves): save {(t1 - t0) * 1e3:.1f} ms, "
        f"restore onto the card {(t2 - t1) * 1e3:.1f} ms (host wall)")
    return {"save_ms": (t1 - t0) * 1e3, "restore_ms": (t2 - t1) * 1e3,
            "bytes": n_bytes}


def split_vs_whole(torch, cfg, card):
    """Phase 14b: one step at full width through the dense split path
    under a one-rank NCCL debug mesh (`make_debug_mesh(1, 1)`: the params
    and moments placed into the rank's blocks, its collectives run over
    one-rank groups) against the no-mesh step, on the same params and
    batch, arms in turns (whole, split, split, whole), each from a fresh
    copy and fresh moments: loss and ce within F32_TOL, the grad norm
    within F32_TOL (one rank sums no partials), 2 flash launches a layer
    and nothing else in each split step, and the split step's
    collectives all over one-rank groups.  Walls and peak memory
    printed."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_train_step, split_shardings
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.collectives import recording_collectives
    from repro_torch.parallel.sharding import place, use_mesh
    from repro_torch.tree import tree_map
    params0, batch = train_params(torch, cfg), train_batch(torch, cfg)
    step_fn = make_train_step(cfg, peak_lr=FALL_LR, warmup=1)
    mesh = make_debug_mesh(1, 1)
    runs = {"whole": [], "split": []}
    launches = None
    try:
        with use_mesh(mesh):
            psh = split_shardings(cfg, mesh)["params"]
        for arm in ("whole", "split", "split", "whole"):
            with (use_mesh(mesh) if arm == "split"
                  else contextlib.nullcontext()):
                params = (place(params0, psh) if arm == "split"
                          else tree_map(torch.clone, params0))
                opt = adamw_init(params)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_launch_counts()
                t0 = time.perf_counter()
                with recording_collectives() as recs:
                    # the metrics alone: the returned state is the
                    # arm's own tensors, freed with it
                    m = step_fn(params, opt, batch, 1)[2]
                    metrics = {k: float(v) for k, v in m.items()}
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            counts = launch_counts()
            runs[arm].append({
                **metrics, "wall_ms": wall,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "collectives": len(recs),
                "model_axis": sum(1 for r in recs if r.axis == "model"),
                "groups": sorted({r[2] for r in recs})})
            if arm == "split":
                want = dict({n: 0 for n in counts},
                            flash_attention=2 * cfg.n_layers)
                if counts != want:
                    raise AssertionError(f"split step launches {counts}, "
                                         f"want {want}")
                launches = launches or counts
            del params, opt
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    w, sp = runs["whole"][0], runs["split"][0]
    for r in runs["split"]:
        if not (r["groups"] == [1] and r["model_axis"] > 0):
            raise AssertionError(f"the split step's collectives: {r}")
    for k in ("loss", "ce", "grad_norm"):
        for r in runs["split"] + runs["whole"][1:]:
            if abs(r[k] - w[k]) > F32_TOL * abs(w[k]):
                raise AssertionError(f"split vs whole {k}: {r[k]} vs {w[k]}")
    walls = {arm: [f"{r['wall_ms']:.1f}" for r in rs]
             for arm, rs in runs.items()}
    log(f"{TRAIN_ARCH} B{TRAIN_B} S{TRAIN_S} through the dense split path "
        f"on a one-rank NCCL mesh ({card}): loss {sp['loss']:.6f} vs "
        f"{w['loss']:.6f} whole, grad norm {sp['grad_norm']:.6f} vs "
        f"{w['grad_norm']:.6f} (tolerance {F32_TOL} relative); "
        f"{sp['collectives']} collectives recorded a step on this thread "
        f"({sp['model_axis']} over model; the backward's run on autograd's "
        f"thread), groups of {sp['groups']}; walls in turns (ms) whole "
        f"{walls['whole']}, split {walls['split']}; peak memory "
        f"whole {w['peak_gib']:.2f} GiB, split {sp['peak_gib']:.2f} GiB "
        f"(the copy of the initial params included); launches "
        f"{json.dumps(launches)}")
    del params0, batch
    return launches, runs


# phase 14b's MoE arm: deepseek-v2-lite-16b at full width cut to its dense
# layer and 3 of its 26 MoE layers (~27 GB of params, gradients and
# moments)
MOE_TRAIN_ARCH = "deepseek-v2-lite-16b"
MOE_TRAIN_LAYERS = 4


def moe_split_vs_whole(torch, card):
    """Phase 14b's MoE arm: deepseek-v2-lite-16b at full width (MLA, 64
    experts top-6, 2 shared, vocab 102,400) cut to MOE_TRAIN_LAYERS
    layers, one step at B 4 x S 2,048 through the split path (the params
    and moments placed, the MoE layers' all-to-all body on the rank's
    block of the stream, MLA split by heads) and one through the
    whole-tensor mesh path (the same step with `split_shardings` giving
    None: the whole params on the rank, the MoE layers' bodies on its
    blocks of the whole tensors), both on one one-rank NCCL
    debug mesh, in turns (split, whole, whole, split), each from a fresh
    copy and fresh moments, freed before the next.  Both see the same
    token block, so the same capacity and drops.  Fails unless loss and
    ce are within F32_TOL and the grad norm within BF16_TOL of the whole
    arm's, the tokens dropped in each MoE layer are equal, and each split
    step launches the flash kernel 2 x layers times (forward and remat)
    and nothing else."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_train_step, split_shardings
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import place, use_mesh
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    n_moe = sum(cfg.layer_is_moe)
    params0, batch = train_params(torch, cfg), train_batch(torch, cfg)
    step_fn = make_train_step(cfg, peak_lr=FALL_LR, warmup=1)
    mesh = make_debug_mesh(1, 1)
    runs = {"split": [], "whole": []}
    launches = None
    try:
        with use_mesh(mesh):
            psh = split_shardings(cfg, mesh)["params"]
        for arm in ("split", "whole", "whole", "split"):
            with use_mesh(mesh):
                params = (place(params0, psh) if arm == "split"
                          else tree_map(torch.clone, params0))
                opt = adamw_init(params)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_launch_counts()
                dispatches = []
                whole = (mock.patch.object(steps, "split_shardings",
                                           lambda cfg, mesh: None)
                         if arm == "whole" else contextlib.nullcontext())
                t0 = time.perf_counter()
                with recording_dispatch(dispatches), whole:
                    m = step_fn(params, opt, batch, 1)[2]
                    metrics = {k: float(v) for k, v in m.items()}
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            counts = launch_counts()
            # the forward pass's dispatches, one a MoE layer (the remat's
            # recomputation repeats them)
            dropped = [int((d["slot"] < 0).sum()) for d in dispatches[:n_moe]]
            runs[arm].append({
                **metrics, "wall_ms": wall, "dropped": dropped,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
            want = dict({n: 0 for n in counts},
                        flash_attention=2 * cfg.n_layers)
            if counts != want:
                raise AssertionError(f"{arm} step launches {counts}, want "
                                     f"{want}")
            if arm == "split":
                launches = launches or counts
            del params, opt, m, dispatches
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    w, sp = runs["whole"][0], runs["split"][0]
    for r in runs["split"] + runs["whole"]:
        for k in ("loss", "ce", "grad_norm"):
            tol = BF16_TOL if k == "grad_norm" else F32_TOL
            if not (math.isfinite(r[k])
                    and abs(r[k] - w[k]) <= tol * abs(w[k])):
                raise AssertionError(f"MoE split vs whole {k}: {r[k]} vs "
                                     f"{w[k]} (tolerance {tol})")
        if r["dropped"] != w["dropped"]:
            raise AssertionError(f"tokens dropped per MoE layer: "
                                 f"{r['dropped']} vs {w['dropped']}")
    walls = {arm: [f"{r['wall_ms']:.1f}" for r in rs]
             for arm, rs in runs.items()}
    log(f"{MOE_TRAIN_ARCH} (full width, {cfg.n_layers} layers: "
        f"{cfg.n_layers - n_moe} dense + {n_moe} MoE) B{TRAIN_B} "
        f"S{TRAIN_S} through the MoE split path vs the whole-tensor mesh "
        f"path on a one-rank NCCL mesh ({card}): loss {sp['loss']:.6f} vs "
        f"{w['loss']:.6f}, ce {sp['ce']:.6f} vs {w['ce']:.6f} (tolerance "
        f"{F32_TOL} relative), grad norm {sp['grad_norm']:.6f} vs "
        f"{w['grad_norm']:.6f} (tolerance {BF16_TOL}), aux {sp['aux']:.6f} "
        f"vs {w['aux']:.6f}; tokens dropped per MoE layer {sp['dropped']} "
        f"vs {w['dropped']} of {TRAIN_B * TRAIN_S * cfg.moe_topk} "
        f"assignments; flash launches a step "
        f"{launches['flash_attention']} (forward + remat); walls in turns "
        f"(ms) split {walls['split']}, whole {walls['whole']}; peak memory "
        f"split {sp['peak_gib']:.2f} GiB, whole {w['peak_gib']:.2f} GiB "
        f"(the initial params' copy included)")
    del params0, batch
    return launches, runs


def training(torch, card):
    """Phase 14: training at minicpm-2b's full width, and phase 14b's MoE
    arm at deepseek-v2-lite-16b's."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    fn = check_function(torch)
    torch.cuda.empty_cache()
    launches, cli_walls, peak = train_cli(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params, batch = train_params(torch, cfg), train_batch(torch, cfg)
    vs_plain = grads_vs_plain(torch, cfg, params, batch)
    gc.collect()
    torch.cuda.empty_cache()
    falls = loss_falls(torch, cfg, params, batch)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    split_launches, split = split_vs_whole(torch, cfg, card)
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches, moe_split = moe_split_vs_whole(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = smoke_resume(torch)
    secs = time.perf_counter() - t_phase
    log(f"phase 14 (training): {secs:.1f} s ({card})")
    return ({"cli": launches, "split": split_launches,
             "moe_split": moe_launches},
            {"function": fn, "cli_walls_ms": cli_walls,
             "cli_peak_gib": peak / 2**30,
             "tokens_per_s": TRAIN_B * TRAIN_S / cli_walls[-1] * 1e3,
             "loss_falls": falls, "vs_plain": vs_plain,
             "split_vs_whole": split, "moe_split_vs_whole": moe_split,
             "smoke_checkpoint": ckpt,
             "seconds": secs})


# ------------------------------------------------------------ phase 15
# (arch, shape, multi-pod) of the dry-run cells: the two dense train
# cells (rank 0's split step) with their rooflines and a multi-pod MoE
# decode cell, the reference's sharding-proof run (no roofline)
DRYRUN_CELLS = (("gemma-7b", "train_4k", False),
                ("minicpm-2b", "train_4k", False),
                ("deepseek-v2-lite-16b", "decode_32k", True))
# PR 32's counts of the two train cells, the whole step over 256 chips
# (PERF.md section 5): compute, memory and collective ms a device
DIVIDED_PR32 = {"gemma-7b": (278.8, 527.8, 6.7),
                "minicpm-2b": (99.6, 594.8, 2.1)}
# FLOPs and bytes of one step counted on `meta` and on the card: the same
# aten ops and the same kernel formula, so equal but for float sums
COUNT_TOL = 1e-6


def dryrun_cells(torch, card):
    """Phase 15a: each DRYRUN_CELLS cell through `run_cell`, in this
    process; no process group may be left and no kernel launched."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.roofline.analysis import HW
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"roofline HBM size {HW['hbm_bytes']:,} bytes against the card's "
        f"{total:,} ({HW['hbm_bytes'] / total:.3f})")
    if not 0.9 <= HW["hbm_bytes"] / total <= 1.0:
        raise AssertionError("roofline HW['hbm_bytes'] is not this card's "
                             "HBM size")
    cells = {}
    for arch, shape, multi_pod in DRYRUN_CELLS:
        t0 = time.perf_counter()
        cell = run_cell(arch, shape, multi_pod)
        secs = time.perf_counter() - t0
        if dist.is_initialized():
            raise AssertionError(f"dry run {arch} {shape}: a process group "
                                 f"is left")
        roof = cell["roofline"]
        if (roof is None) != multi_pod:
            raise AssertionError(f"dry run {arch} {shape}: roofline "
                                 f"{roof!r} on mesh {cell['mesh']}")
        terms = ("" if roof is None else
                 f", compute {roof['compute_s']:.4g} s, memory "
                 f"{roof['memory_s']:.4g} s, collective "
                 f"{roof['collective_s']:.4g} s, dominant {roof['dominant']},"
                 f" useful-FLOPs {roof['useful_flops_ratio']:.3f}")
        log(f"dry run {arch} {shape} {cell['mesh']} ({cell['chips']} chips, "
            f"{cell['count']}): {cell['per_device_gb']} GB a device, fits "
            f"{cell['fits_hbm']}{terms}; kernel calls counted "
            f"{cell['kernel_calls']}, collectives "
            f"{cell['collective_ops_full_hlo']}; {secs:.1f} s")
        split = cell["dense_split"]
        if (split is not None) != (arch in DIVIDED_PR32):
            raise AssertionError(f"dry run {arch} {shape}: split {split}")
        if split is not None:
            # rank 0's split step, beside PR 32's whole step over the chips
            if cell["collectives_not_counted"]:
                raise AssertionError(f"{arch}: a split cell leaves out "
                                     f"{cell['collectives_not_counted']}")
            by_axis = cell["collectives_by_axis"]
            if not by_axis["model"]["n_reduce-scatter"]:
                raise AssertionError(f"{arch}: no model-axis transition")
            coll = roof["collectives"]
            log(f"  rank 0's split step: {roof['flops_per_device']:,.0f} "
                f"FLOPs, {roof['bytes_per_device']:,.0f} bytes, "
                f"{coll['total']:,.0f} collective wire bytes a device "
                f"(by kind: " + ", ".join(
                    f"{k} {coll[k]:,.0f} in {coll['n_' + k]}"
                    for k in ("all-gather", "reduce-scatter", "all-reduce",
                              "all-to-all")) + "; by axis: " + ", ".join(
                    f"{a} {v['total']:,.0f}" for a, v in by_axis.items())
                + f"); attention: {split['attention']}, "
                f"{split['q_heads_per_rank']} query heads a rank; terms "
                f"compute {roof['compute_s'] * 1e3:.1f} / memory "
                f"{roof['memory_s'] * 1e3:.1f} / collective "
                f"{roof['collective_s'] * 1e3:.1f} ms, dominant "
                f"{roof['dominant']}; PR 32's whole step over the chips "
                f"{' / '.join(map(str, DIVIDED_PR32[arch]))} ms")
        cells[f"{arch}/{shape}/{cell['mesh']}"] = {
            "per_device_gb": cell["per_device_gb"],
            "fits_hbm": cell["fits_hbm"], "seconds": secs,
            "dense_split": cell["dense_split"],
            "collectives": None if roof is None else roof["collectives"],
            "collectives_by_axis": cell["collectives_by_axis"],
            "roofline": None if roof is None else {
                k: roof[k] for k in ("compute_s", "memory_s", "collective_s",
                                     "dominant", "useful_flops_ratio",
                                     "flops_per_device",
                                     "bytes_per_device")}}
    return cells


def step_vs_count(torch, card):
    """Phase 15b: one minicpm-2b training step at B TRAIN_B x S TRAIN_S
    counted by the dry run's code on `meta` tensors and on the card; the
    counts must agree, and the measured step wall must sit at or above
    the roofline bound of one card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _model_flops, count_step
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.roofline.analysis import roofline_terms
    from repro_torch.tree import tree_map
    cfg = get_config(TRAIN_ARCH)
    params, batch = train_params(torch, cfg), train_batch(torch, cfg)
    opt = adamw_init(params)

    def on_meta(tree):
        return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)
    step_fn = make_train_step(cfg, peak_lr=FALL_LR, warmup=1)
    _, meta, meta_s = count_step(
        step_fn, (on_meta(params), adamw_init(on_meta(params)),
                  on_meta(batch), 1), train=True)
    zero_launch_counts()
    torch.cuda.synchronize()
    _, chip, chip_s = count_step(step_fn, (params, opt, batch, 1),
                                 train=True)
    torch.cuda.synchronize()
    launches = launch_counts()
    rel = {k: abs(chip[k] - meta[k]) / max(abs(meta[k]), 1.0)
           for k in ("flops", "bytes")}
    log(f"one {TRAIN_ARCH} train step B{TRAIN_B} S{TRAIN_S} counted on "
        f"meta ({meta_s:.1f} s) and on the card ({chip_s:.1f} s): FLOPs "
        f"{meta['flops']:,} / {chip['flops']:,}, bytes {meta['bytes']:,} / "
        f"{chip['bytes']:,} (relative {rel['flops']:.3g}, {rel['bytes']:.3g};"
        f" tolerance {COUNT_TOL}); kernel calls {meta['kernels']} / "
        f"{chip['kernels']}; launches {launches}")
    if max(rel.values()) > COUNT_TOL or meta["kernels"] != chip["kernels"]:
        raise AssertionError("the step's counts on meta and on the card "
                             "differ")
    if launches["flash_attention"] != chip["kernels"].get("flash_attention"):
        raise AssertionError("the card's tally and its flash launches differ")
    walls = []
    for step in range(2, 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, step)
        float(m["loss"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    spec = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN_S,
                               global_batch=TRAIN_B)
    roof = roofline_terms(
        arch=TRAIN_ARCH, shape=f"train B{TRAIN_B} S{TRAIN_S}",
        mesh_name="one card", chips=1,
        cost_analysis={"flops": chip["flops"], "bytes accessed": chip["bytes"]},
        hlo_text="", model_flops_global=_model_flops(cfg, spec))
    bound_s = max(roof.compute_s, roof.memory_s)
    wall = min(walls)
    log(f"the step's roofline on one card ({card}): compute "
        f"{roof.compute_s * 1e3:.2f} ms, memory {roof.memory_s * 1e3:.2f} "
        f"ms, bound {bound_s * 1e3:.2f} ms by {roof.dominant}, useful-FLOPs "
        f"{roof.useful_flops_ratio:.3f}; step walls "
        f"{[f'{w * 1e3:.1f}' for w in walls]} ms, the fastest at "
        f"{bound_s / wall:.1%} of its bound")
    if wall < bound_s:
        raise AssertionError(f"a step of {wall * 1e3:.1f} ms ran under its "
                             f"roofline bound {bound_s * 1e3:.1f} ms: a "
                             f"count is wrong")
    del params, opt, batch
    return launches, {
        "flops": chip["flops"], "bytes": chip["bytes"],
        "relative": rel, "kernels": chip["kernels"],
        "count_s": {"meta": meta_s, "card": chip_s},
        "compute_ms": roof.compute_s * 1e3, "memory_ms": roof.memory_s * 1e3,
        "bound_ms": bound_s * 1e3, "bound_by": roof.dominant,
        "walls_ms": [w * 1e3 for w in walls],
        "share_of_bound": bound_s / wall}


def dry_run(torch, card):
    """Phase 15: the dry run's cells, then a step counted against the
    card's own."""
    t_phase = time.perf_counter()
    zero_launch_counts()
    cells = dryrun_cells(torch, card)
    cell_launches = launch_counts()
    if any(cell_launches.values()):
        raise AssertionError(f"the dry run launched kernels: {cell_launches}")
    gc.collect()
    torch.cuda.empty_cache()
    step_launches, step = step_vs_count(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"phase 15 (dry run and roofline): {secs:.1f} s ({card})")
    return ({"cells": cell_launches, "counted_step": step_launches},
            {"cells": cells, "step": step, "seconds": secs})


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
    # f32 products in full f32 (PyTorch's default, stated): the plain
    # versions the f32 kernels are held against must not run in TF32
    # (check_flash turns TF32 on once, for the one-pass probe, and off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    sass = tensor_core_counts(build)
    log(f"tensor-core instructions in each library (SASS): {json.dumps(sass)}")
    for name in ("crossbar_mvm", "flash_attention"):
        if not any(sass[name].values()):
            raise AssertionError(f"{name}: no tensor-core instruction in its "
                                 f"library")
    if not sass["flash_attention_f32"]["HMMA"]:   # split TF32 on mma.sync
        raise AssertionError(f"flash_attention_f32: no HMMA in its library: "
                             f"{sass['flash_attention_f32']}")
    if any(sass["paged_attention_f32"].values()):  # full f32 FMAs only
        raise AssertionError(f"paged_attention_f32: tensor-core instructions "
                             f"in its library: {sass['paged_attention_f32']}")

    # phase 2: kernels against their plain versions
    paged = {}
    for label, shape in PAGED_TIMED.items():
        paged[label] = check_paged(torch, **shape)
        err, ms, plain_ms, sdpa_ms, (b, by), warm_ms = paged[label]
        log(f"paged_attention {label}: err {err:.3g}, {ms:.4f} ms cold, "
            f"{warm_ms:.4f} ms back to back (plain {plain_ms:.4f} ms, sdpa "
            f"over pre-gathered K/V {sdpa_ms:.4f} ms cold), bound {b:.4f} "
            f"ms by {by}, kernel/bound {ms / b:.2f}")
    for D, (H, Hkv), page, T in PAGED_UNTIMED:
        err = check_paged(torch, B=8, H=H, Hkv=Hkv, D=D, page=page, T=T,
                          seed=D * 31 + H, timed=False)[0]
        log(f"paged_attention B8 H{H} Hkv{Hkv} G{H // Hkv} D{D} page{page} "
            f"T{T}: err {err:.3g}")
    err = check_paged(torch, B=3, H=4, Hkv=2, D=32, page=4, T=6, seed=4,
                      timed=False)[0]
    log(f"paged_attention B3 Hkv2 G2 D32 page4 T6: err {err:.3g}")
    for label, shape in PAGED_PATH_SHAPES.items():
        err = check_paged(torch, **shape, timed=False)[0]
        log(f"paged_attention {label}: err {err:.3g}")
    label, shape = planes_paged_shape(get_config("gemma-7b"))
    err = check_paged(torch, **shape, timed=False)[0]
    log(f"paged_attention {label}: err {err:.3g}")
    plans = check_split_plan(torch)
    log(f"paged_attention split plans (splits, pages per split) of the "
        f"long tables: {plans}")
    for D, (H, Hkv), page, T in PAGED_LONG_TABLES:
        if plans[page, T][1] <= 256:
            raise AssertionError(f"page{page} T{T}: the chunk of "
                                 f"{plans[page, T][1]} pages does not "
                                 f"slide the page-id window")
        err = check_paged(torch, B=8, H=H, Hkv=Hkv, D=D, page=page, T=T,
                          seed=T + page, timed=False)[0]
        log(f"paged_attention B8 H{H} Hkv{Hkv} G{H // Hkv} D{D} page{page} "
            f"T{T} (one split, sliding page-id window): err {err:.3g}")
    err = check_flash(torch, S=77, H=8, D=64, seed=3, Hkv=2, timed=False)[0]
    log(f"flash_attention S77 H8 Hkv2 D64 causal (GQA, ragged): err "
        f"{err:.3g}")
    # every native head dim, and the zero-padded ones
    for D in (8, 16, 24, 80, 32, 64, 128, 256):
        for causal in (True, False):
            err = check_flash(torch, S=200, H=4, D=D, seed=D + causal,
                              Hkv=2, B=2, causal=causal, timed=False)[0]
            log(f"flash_attention B2 S200 H4 Hkv2 D{D} "
                f"{'causal' if causal else 'full'} (GQA, ragged): err "
                f"{err:.3g}")
    err = check_flash(torch, S=200, H=32, D=128, seed=16, Hkv=2, B=2,
                      timed=False)[0]
    log(f"flash_attention B2 S200 H32 Hkv2 (G16) D128 causal: err {err:.3g}")
    flash = {}
    for B, S in ((1, 512), (1, 1000), (4, 512)):
        flash[B, S] = check_flash(torch, S=S, H=16, D=256, seed=S + B, B=B)
        err, ms, plain_ms, lib_ms, (b, by) = flash[B, S]
        log(f"flash_attention B{B} S{S} H16 D256 causal: err {err:.3g}, "
            f"{ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
            f"kernel/sdpa {ms / lib_ms:.2f}), bound {b:.4f} ms by {by}")
    # hymba-1.5b's global layers prefilling phase 11's long prompt
    hymba = check_flash(torch, S=LONG_PROMPT, H=25, D=64, seed=LONG_PROMPT,
                        Hkv=5)
    err, ms, plain_ms, lib_ms, (b, by) = hymba
    log(f"flash_attention B1 S{LONG_PROMPT} H25 Hkv5 (G5) D64 causal "
        f"(hymba-1.5b): err {err:.3g}, {ms:.4f} ms (plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, kernel/sdpa {ms / lib_ms:.2f}), bound "
        f"{b:.4f} ms by {by}, kernel/bound {ms / b:.2f}")
    mla = check_flash_mla(torch)
    err, ms, plain_ms, lib_ms, (b, by) = mla
    log(f"flash_attention B1 S512 H16 D192 (MLA, V 128 zero-padded to 192) "
        f"causal: err {err:.3g}, {ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa "
        f"on the unpadded inputs {lib_ms:.4f} ms, kernel/sdpa "
        f"{ms / lib_ms:.2f}), bound of the unpadded work {b:.4f} ms by "
        f"{by}, kernel/bound {ms / b:.2f}")
    # the MLA training route's shape: deepseek-v2-lite-16b at phase 14's
    # B 4 x S 2,048, every head on one rank, the lse mode
    mla_train = check_flash_mla(torch, S=TRAIN_S, seed=2048, B=TRAIN_B,
                                lse=True)
    err, ms, plain_ms, lib_ms, (b, by) = mla_train
    log(f"flash_attention B{TRAIN_B} S{TRAIN_S} H16 D192 (MLA training "
        f"shape, V 128 zero-padded, lse mode) causal: err {err:.3g}, "
        f"{ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa forward on the "
        f"unpadded inputs {lib_ms:.4f} ms, kernel/sdpa {ms / lib_ms:.2f}), "
        f"bound of the unpadded work {b:.4f} ms by {by}, kernel/bound "
        f"{ms / b:.2f}")
    # f32: paged at F32_TOL, flash at FLASH_F32_TOL
    f32 = torch.float32
    paged32, errs32 = {}, {"paged": [], "flash": []}
    for label in PAGED_F32_TIMED:
        paged32[label] = check_paged(torch, **PAGED_TIMED[label], dtype=f32)
        err, ms, plain_ms, sdpa_ms, (b, by), warm_ms = paged32[label]
        errs32["paged"].append(err)
        log(f"paged_attention f32 {label}: err {err:.3g}, {ms:.4f} ms cold, "
            f"{warm_ms:.4f} ms back to back (plain {plain_ms:.4f} ms, sdpa "
            f"over pre-gathered K/V {sdpa_ms:.4f} ms cold), bound {b:.4f} "
            f"ms by {by}, kernel/bound {ms / b:.2f}")
    for D, (H, Hkv), page, T in PAGED_UNTIMED:
        err = check_paged(torch, B=8, H=H, Hkv=Hkv, D=D, page=page, T=T,
                          seed=D * 31 + H, timed=False, dtype=f32)[0]
        errs32["paged"].append(err)
        log(f"paged_attention f32 B8 H{H} Hkv{Hkv} G{H // Hkv} D{D} "
            f"page{page} T{T}: err {err:.3g}")
    plans32 = check_split_plan(torch, "paged_attention_f32")
    log(f"paged_attention f32 split plans of the long tables: {plans32}")
    for D, (H, Hkv), page, T in PAGED_LONG_TABLES:
        if plans32[page, T][1] <= 256:
            raise AssertionError(f"f32 page{page} T{T}: the chunk of "
                                 f"{plans32[page, T][1]} pages does not "
                                 f"slide the page-id window")
        err = check_paged(torch, B=8, H=H, Hkv=Hkv, D=D, page=page, T=T,
                          seed=T + page, timed=False, dtype=f32)[0]
        errs32["paged"].append(err)
        log(f"paged_attention f32 B8 H{H} Hkv{Hkv} G{H // Hkv} D{D} "
            f"page{page} T{T} (one split, sliding page-id window): err "
            f"{err:.3g}")
    for D in (8, 24, 80, 256):
        for causal in (True, False):
            err = check_flash(torch, S=200, H=4, D=D, seed=D + causal,
                              Hkv=2, B=2, causal=causal, timed=False,
                              dtype=f32)[0]
            errs32["flash"].append(err)
            log(f"flash_attention f32 B2 S200 H4 Hkv2 D{D} "
                f"{'causal' if causal else 'full'} (GQA, ragged): err "
                f"{err:.3g}")
    # the lse mode (the training forward) of both kernels: every native
    # head dim and a padded one in bf16, causal and full, and f32
    lse_errs = []
    for dtype, dims in ((None, (32, 64, 128, 256, 80)), (f32, (64, 80, 256))):
        for D in dims:
            for causal in (True, False):
                errs = check_flash_lse(torch, S=200, H=4, D=D, seed=D + 7,
                                       Hkv=2, B=2, causal=causal,
                                       dtype=dtype)
                lse_errs.append(errs[1])
                log(f"flash_attention {'f32' if dtype else 'bf16'} lse mode "
                    f"B2 S200 H4 Hkv2 D{D} {'causal' if causal else 'full'}: "
                    f"o err {errs[0]:.3g} (o equal to the serving launch's), "
                    f"lse err {errs[1]:.3g}")
    flash32 = {}
    for Hkv in (16, 4):
        flash32[Hkv] = check_flash(torch, S=512, H=16, D=256, seed=512 + Hkv,
                                   Hkv=Hkv, dtype=f32)
        err, ms, plain_ms, lib_ms, (b, by), extra = flash32[Hkv]
        errs32["flash"].append(err)
        cb, cby = extra["cuda_core_bound"]
        log(f"flash_attention f32 B1 S512 H16 Hkv{Hkv} D256 causal: err "
            f"{err:.3g} (one TF32 pass: {extra['one_pass_tf32_err']:.3g}), "
            f"{ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
            f"kernel/sdpa {ms / lib_ms:.2f}), bound {b:.4f} ms by {by} as "
            f"3xTF32 (kernel/bound {ms / b:.2f}), {cb:.4f} ms by {cby} on "
            f"the CUDA cores")
    delta = {}
    pulses = {}
    for n in (LAYER_CODES, 70_001):
        delta[n] = check_delta_apply(torch, n, seed=n % 997)
        err, ms, plain_ms, lib_ms, (b, by), oop_ms, runs = delta[n]
        log(f"delta_apply n {n:,}: err {err}, {ms:.4f} ms in place, "
            f"{oop_ms:.4f} ms out of place (torch.add on uint8 "
            f"{lib_ms:.4f} ms, kernel/torch.add {oop_ms / lib_ms:.3f}; "
            f"plain {plain_ms:.4f} ms), bound {b:.4f} ms by {by}, "
            f"bound/kernel {b / ms:.3f}; medians of "
            f"{DELTA_ROUNDS} rounds in turns)")
        log(f"delta_apply n {n:,} runs (ms): " + "; ".join(
            f"{k} " + ", ".join(f"{t:.4f}" for t in v)
            for k, v in runs.items()))
        pulses[n] = check_pulse_count(torch, n, seed=n % 991)
        err, got, ms, plain_ms, (b, by) = pulses[n]
        log(f"pulse_count n {n:,}: err {err} (pulses, unchanged {got}), "
            f"{ms:.4f} ms (plain {plain_ms:.4f} ms), bound {b:.4f} ms by "
            f"{by}")
    g = torch.Generator(device="cuda").manual_seed(5)
    for M, K, N in ((70, 300, 90), (8, 3071, 200)):   # ragged tiles and K
        err, ms, *_ = check_crossbar(
            torch, torch.randint(0, 256, (M, K), dtype=torch.uint8,
                                 device="cuda", generator=g),
            torch.randint(0, 256, (K, N), dtype=torch.uint8, device="cuda",
                          generator=g), 131.25, 77.5, 3.1e-4)
        log(f"crossbar_mvm M{M} K{K} N{N} (ragged): err {err:.3g}")

    # phase 3: serve at gemma-7b's full width
    cfg = get_config("gemma-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"init_params {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {time.perf_counter() - t0:.1f} s")
    requests = phase3_requests(cfg.vocab)
    launches, mono_tokens = serve(torch, cfg, params, requests, page=16)

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
    decode_wall_ms = profile_decode(torch, cfg, params, arena)
    profile_prefill(torch, cfg, params, max((p for p, _, _ in requests),
                                            key=len))
    del arena
    torch.cuda.empty_cache()

    # phase 5: the ARAS streaming path, then the crossbar path on its codes
    from repro_torch.kernels.crossbar_mvm.ops import crossbar_mvm
    from repro_torch.kernels.delta_apply.ops import apply_delta
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.pulse_count.ops import pulse_count
    counters = {"delta_apply": apply_delta, "pulse_count": pulse_count,
                "flash_attention": flash_attention}
    ex, batch, s_logits, s_launches = streaming(torch, cfg, params, counters)
    from repro_torch.nn.model import forward
    resident, _, _ = forward(params, {"tokens": batch["tokens"]}, cfg,
                             last_only=True)
    r32 = resident[:, 0, :cfg.vocab].float()
    s32 = s_logits[:, -1, :cfg.vocab].float()
    log(f"streaming (int8 codes) vs resident bf16 weights, last position: "
        f"max abs diff {(s32 - r32).abs().max().item():.4g} at a logit "
        f"scale of {r32.abs().max().item():.4g}; greedy agreement "
        f"{(s32.argmax(-1) == r32.argmax(-1)).float().mean().item():.3f}")
    x_codes, zp_x, mats = crossbar_operands(torch, cfg, ex, batch)
    w, zp_w, sc = mats["w_up"]
    xb = check_crossbar(torch, x_codes, w, zp_x, zp_w, sc)
    err, ms, plain_ms, lib_ms, (b, by) = xb
    log(f"crossbar_mvm M{x_codes.shape[0]} K{w.shape[0]} N{w.shape[1]} "
        f"(gemma-7b layer 0 w_up codes): err {err:.3g}, {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms, kernel/_int_mm "
        f"{ms / lib_ms:.2f}), bound {b:.4f} ms by {by}")
    for t, name in kernel_split(torch, lambda: crossbar_mvm(x_codes, w, zp_x,
                                                            zp_w, sc)):
        log(f"  crossbar_mvm call: {t:.4f} ms  {name[:80]}")
    x_launches = crossbar_path(torch, x_codes, zp_x, mats, crossbar_mvm)
    del ex, batch, s_logits, resident, x_codes, mats, w
    torch.cuda.empty_cache()

    # phase 6: two tenants through an ARAS weight arena at full width
    t_launches = two_tenants(torch, cfg, params, decode_wall_ms)

    # phase 7: chunked prefill and the prefix cache at full width
    t0 = time.perf_counter()
    c_launches = chunked_prefill(torch, cfg, params, requests, mono_tokens)
    log(f"phase 7 (chunked prefill, prefix cache): "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 8: the slot layout and the launcher's default mode
    t0 = time.perf_counter()
    slot_launches = slot_serve(torch, cfg, params, requests, mono_tokens)
    slot_first_step(torch, cfg, params, requests)
    greedy_launches = default_mode(torch, cfg, params)
    cli_launches = default_cli(torch)
    log(f"phase 8 (slot layout, default mode, default CLI): "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 9: the wear, fault and telemetry planes at full width
    plane_launches = planes(torch, cfg, params)

    # phase 10: the dense GQA families and deepseek's MLA + MoE, gemma-7b's
    # weights freed first
    del params
    gc.collect()
    torch.cuda.empty_cache()
    fam_launches, fam_decode, fam_mesh = families(torch, card)
    log(f"phase 10 {MLA_ARCH} decode: {json.dumps(fam_decode)}")
    log(f"phase 10 {MLA_ARCH} mesh ({card}): {json.dumps(fam_mesh)}")

    # phase 11: hymba's attention beside Mamba, and xLSTM, at full width
    rec_launches, rec_profile = recurrent(torch)
    log(f"phase 11 {HYBRID_ARCH} profile: {json.dumps(rec_profile)}")

    # phase 12: the two non-token input modes, hubert's encoder and
    # paligemma's image prefix, at full width
    mode_launches, encoder, vlm_paged = input_modes(torch, card)
    log(f"phase 12 {ENCODER_ARCH} forward: " + json.dumps(
        {k: v for k, v in encoder.items() if k != "flash"}))
    hubert = encoder["flash"]

    # phase 13: the ARAS paper layer (the paper's nets on the card, pulse
    # counts against the simulator's expectation, the example arms)
    paper_launches, paper_summary = paper_layer(torch, card)
    log(f"phase 13 summary: {json.dumps(paper_summary)}")

    # phase 14: training at minicpm-2b's full width
    train_launches, train_summary = training(torch, card)
    log(f"phase 14 summary: {json.dumps(train_summary)}")
    train_fn = train_summary["function"]

    # phase 15: the dry run and the roofline, and a step counted on the card
    gc.collect()
    torch.cuda.empty_cache()
    dry_launches, dry_summary = dry_run(torch, card)
    log(f"phase 15 summary: {json.dumps(dry_summary)}")

    def family_fields(name):
        return {"families_launches": {
            arch: ({run: v[name] for run, v in runs.items()}
                   if arch == MLA_ARCH else runs[name])
            for arch, runs in fam_launches.items()}}

    def recurrent_fields(name):
        return {"recurrent_launches": {
            arch: {run: v[name] for run, v in runs.items()}
            for arch, runs in rec_launches.items()}}

    def input_mode_fields(name):
        return {"input_modes_launches": {
            arch: {run: v[name] for run, v in runs.items()}
            for arch, runs in mode_launches.items()}}

    def paper_fields(name):
        return {"paper_layer_launches": {
            run: v[name] for run, v in paper_launches.items()}}

    def training_fields(name):
        return {"training_launches": train_launches["cli"][name],
                "split_step_launches": train_launches["split"][name],
                "moe_split_step_launches": train_launches["moe_split"][name],
                "dryrun_launches": {run: v[name]
                                    for run, v in dry_launches.items()}}

    # report
    def planes_fields(name):
        return {arm: launches[name]
                for arm, launches in zip(("off", "on"), plane_launches)}

    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/paged_attention/csrc/"
                   "paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:70",
         "launches": launches["paged_attention"],
         "max_abs_err": max([r[0] for r in paged.values()]
                            + [vlm_paged[0]]),
         "ms": paged[PAGED_MAIN][1], "plain_ms": paged[PAGED_MAIN][2],
         "bound_ms": paged[PAGED_MAIN][4][0],
         "bound_by": paged[PAGED_MAIN][4][1], "library_ms": None,
         "two_tenant_launches": t_launches["paged_attention"],
         "chunked_launches": c_launches["paged_attention"],
         "slot_launches": slot_launches["paged_attention"],
         "default_mode_launches": greedy_launches["paged_attention"],
         "planes_launches": planes_fields("paged_attention"),
         **f32_fields(errs32["paged"], paged32[PAGED_F32_MAIN], None),
         "f32_cold_ms_by_shape": {k: v[1] for k, v in paged32.items()},
         "cold_ms_by_shape": {k: v[1] for k, v in paged.items()},
         "bound_ms_by_shape": {k: v[4][0] for k, v in paged.items()},
         **family_fields("paged_attention"),
         **recurrent_fields("paged_attention"),
         **input_mode_fields("paged_attention"),
         "paligemma_max_abs_err": vlm_paged[0], "paligemma_ms": vlm_paged[1],
         "paligemma_plain_ms": vlm_paged[2],
         "paligemma_sdpa_gathered_ms": vlm_paged[3],
         "paligemma_bound_ms": vlm_paged[4][0],
         "paligemma_bound_by": vlm_paged[4][1],
         **paper_fields("paged_attention"),
         **training_fields("paged_attention")},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:67",
         "launches": launches["flash_attention"],
         "max_abs_err": max([f[0] for f in flash.values()]
                            + [hymba[0], hubert[0]]),
         "ms": flash[1, 512][1], "plain_ms": flash[1, 512][2],
         "bound_ms": flash[1, 512][4][0], "bound_by": flash[1, 512][4][1],
         "library_ms": flash[1, 512][3],
         "two_tenant_launches": t_launches["flash_attention"],
         "chunked_launches": c_launches["flash_attention"],
         "slot_launches": slot_launches["flash_attention"],
         "default_mode_launches": greedy_launches["flash_attention"],
         "planes_launches": planes_fields("flash_attention"),
         **f32_fields(errs32["flash"], flash32[16], flash32[16][3]),
         "mla_max_abs_err": mla[0], "mla_ms": mla[1], "mla_plain_ms": mla[2],
         "mla_library_ms": mla[3], "mla_bound_ms": mla[4][0],
         "mla_bound_by": mla[4][1],
         "mla_training_shape": f"B{TRAIN_B} S{TRAIN_S} H16 D192 causal lse",
         "mla_training_max_abs_err": mla_train[0],
         "mla_training_ms": mla_train[1],
         "mla_training_plain_ms": mla_train[2],
         "mla_training_sdpa_fwd_ms": mla_train[3],
         "mla_training_bound_ms": mla_train[4][0],
         "mla_training_bound_by": mla_train[4][1],
         **family_fields("flash_attention"),
         "mesh_launches": fam_mesh["flash_launches"],
         "hymba_max_abs_err": hymba[0], "hymba_ms": hymba[1],
         "hymba_plain_ms": hymba[2], "hymba_library_ms": hymba[3],
         "hymba_bound_ms": hymba[4][0], "hymba_bound_by": hymba[4][1],
         **recurrent_fields("flash_attention"),
         "hubert_max_abs_err": hubert[0], "hubert_ms": hubert[1],
         "hubert_plain_ms": hubert[2], "hubert_library_ms": hubert[3],
         "hubert_bound_ms": hubert[4][0], "hubert_bound_by": hubert[4][1],
         **input_mode_fields("flash_attention"),
         "f32_bound_cuda_cores_ms": flash32[16][5]["cuda_core_bound"][0],
         "f32_one_pass_tf32_err": flash32[16][5]["one_pass_tf32_err"],
         **paper_fields("flash_attention"),
         **training_fields("flash_attention"),
         "lse_max_abs_err": max(lse_errs + [train_fn["errs"]["lse"]]),
         "training_shape": f"B{TRAIN_B} S{TRAIN_S} H36 D64 causal",
         "training_errs": train_fn["errs"],
         "training_fwd_ms": train_fn["fwd_ms"],
         "training_lse_ms": train_fn["lse_ms"],
         "training_fwd_bound_ms": train_fn["fwd_bound"][0],
         "training_fwd_bound_by": train_fn["fwd_bound"][1],
         "training_sdpa_fwd_ms": train_fn["sdpa_fwd_ms"],
         "training_backward_ms": train_fn["bwd_ms"],
         "training_backward_bound_ms": train_fn["bwd_bound"][0],
         "training_backward_bound_by": train_fn["bwd_bound"][1],
         "training_plain_fwd_bwd_ms": train_fn["plain_ms"],
         "training_sdpa_fwd_bwd_ms": train_fn["sdpa_fwd_bwd_ms"]},
        {"name": "delta_apply", "route": "cuda",
         "source": "src/repro_torch/kernels/delta_apply/csrc/delta_apply.cu",
         "replaces": "src/repro/kernels/delta_apply/kernel.py:21",
         "launches": s_launches["delta_apply"],
         "max_abs_err": max(delta[n][0] for n in delta),
         "ms": delta[LAYER_CODES][1], "plain_ms": delta[LAYER_CODES][2],
         "bound_ms": delta[LAYER_CODES][4][0],
         "bound_by": delta[LAYER_CODES][4][1],
         "library_ms": delta[LAYER_CODES][3],
         "slot_launches": slot_launches["delta_apply"],
         "planes_launches": planes_fields("delta_apply"),
         **paper_fields("delta_apply"),
         **training_fields("delta_apply")},
        {"name": "pulse_count", "route": "cuda",
         "source": "src/repro_torch/kernels/pulse_count/csrc/pulse_count.cu",
         "replaces": "src/repro/kernels/pulse_count/kernel.py:32",
         "launches": s_launches["pulse_count"],
         "max_abs_err": max(pulses[n][0] for n in pulses),
         "ms": pulses[LAYER_CODES][2], "plain_ms": pulses[LAYER_CODES][3],
         "bound_ms": pulses[LAYER_CODES][4][0],
         "bound_by": pulses[LAYER_CODES][4][1], "library_ms": None,
         "two_tenant_launches": t_launches["pulse_count"],
         "slot_launches": cli_launches["pulse_count"],
         "planes_launches": planes_fields("pulse_count"),
         **paper_fields("pulse_count"),
         **training_fields("pulse_count")},
        {"name": "crossbar_mvm", "route": "cuda",
         "source": "src/repro_torch/kernels/crossbar_mvm/csrc/"
                   "crossbar_mvm.cu",
         "replaces": "src/repro/kernels/crossbar_mvm/kernel.py:37",
         "launches": x_launches, "max_abs_err": xb[0], "ms": xb[1],
         "plain_ms": xb[2], "bound_ms": xb[4][0], "bound_by": xb[4][1],
         "library_ms": xb[3],
         "slot_launches": slot_launches["crossbar_mvm"],
         "planes_launches": planes_fields("crossbar_mvm"),
         **paper_fields("crossbar_mvm"),
         **training_fields("crossbar_mvm")},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
