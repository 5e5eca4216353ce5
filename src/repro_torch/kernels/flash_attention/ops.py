"""Wrapper for the flash-attention forward kernel (prefill attention).

GQA-native: q (B, Sq, H, D) attends over k/v (B, Skv, Hkv, D) with query
head h reading KV head h // (H / Hkv).  A CPU tensor goes to the plain
PyTorch version (`ref.py`); a CUDA tensor launches a hand-written kernel
or raises: bf16 the `wgmma` kernel (`csrc/flash_attention.cu`), f32 the
split-TF32 kernel (`csrc/flash_attention_f32.cu`: each f32 operand split
into a TF32 hi and lo, three `mma.sync` products per fragment, f32 sums;
one TF32 pass would not hold the reference's 3e-4).
`flash_attention.launches` counts kernel launches, of either kernel, and
nothing else.  With `return_lse` both kernels also write each row's f32
log-sum-exp (B, H, Sq), the statistic the training backward
(`repro_torch.nn.flash`) recomputes its probabilities from; without it
they write `o` alone, as the serving path launches them.

A `meta` tensor (the dry run's shape-only count) takes neither: the
wrapper returns empty outputs of the kernel's shapes and dtypes and adds
the call's work (`work`) to the open tally (`repro_torch.kernels.counting`).
A CUDA launch adds the same work by the same formula, so a step counted on
`meta` and on the card agree.  Any other device raises.

The bf16 kernel is built for head dims 32, 64, 128 and 256.  Any other
multiple of 8 up to 256 is zero-padded along D to the next of those: zero
columns add nothing to Q·Kᵀ, the true 1/sqrt(D) is passed as the scale,
and the zero V columns are sliced off the output, so the result is exact.
The padding costs one copy of q, k and v, and only off the four native
widths.  The f32 kernel takes every such head dim as it is.
"""
import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import aligned16, build, nbytes, tally_work
from repro_torch.kernels.flash_attention.ref import flash_attention_plain


@functools.cache
def _bind(library: str = "flash_attention"):
    symbol = ("flash_attention_f32" if library == "flash_attention_f32"
              else "flash_attention_bf16")
    fn = getattr(build.load(library), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_for(q, k, v) -> str:
    """The kernel library that takes these inputs: "flash_attention" for
    bf16 q/k/v, "flash_attention_f32" for f32.  Raises ValueError on any
    other dtype or a mix."""
    dtypes = {q.dtype, k.dtype, v.dtype}
    if dtypes == {torch.bfloat16}:
        return "flash_attention"
    if dtypes == {torch.float32}:
        return "flash_attention_f32"
    raise ValueError(f"flash_attention kernels take bf16 or f32 q/k/v of "
                     f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")


NATIVE_HEAD_DIMS = (32, 64, 128, 256)


def native_head_dim(head_dim: int) -> int:
    """The kernel's width for `head_dim`: the least of NATIVE_HEAD_DIMS at
    or above it.  Raises ValueError unless head_dim is a multiple of 8
    from 8 to 256."""
    if head_dim % 8 or not 8 <= head_dim <= 256:
        raise ValueError(f"flash_attention kernel needs a head_dim that is "
                         f"a multiple of 8 from 8 to 256; got {head_dim}")
    return next(n for n in NATIVE_HEAD_DIMS if n >= head_dim)


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """`x` zero-padded along its last axis to `width` (itself when it
    already has that width)."""
    return x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1]))


def attended_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """(query, key) pairs one (batch, head) attends: every pair, or under
    the causal mask key j <= query i."""
    if not causal:
        return Sq * Skv
    m = min(Sq, Skv)
    return m * (m + 1) // 2 + (Sq - m) * Skv


def work(q, k, v, causal: bool, return_lse: bool = False):
    """(flops, bytes) of one call: 4·B·H·D a pair attended (Q·Kᵀ and P·V),
    and q, k, v read once, o (and lse) written once, at the true D."""
    B, Sq, H, D = q.shape
    flops = 4 * B * H * D * attended_pairs(Sq, k.shape[1], causal)
    n_bytes = 2 * nbytes(q) + nbytes(k, v)
    return flops, n_bytes + (4 * B * H * Sq if return_lse else 0)


def _kernel_width(q, k, v) -> int:
    """The head dim the kernel for these inputs runs at (raises outside
    the contract): the bf16 kernel's native width, or D for f32."""
    D = q.shape[-1]
    width = native_head_dim(D)
    return D if kernel_for(q, k, v) == "flash_attention_f32" else width


def _meta(q, k, v, causal: bool, return_lse: bool):
    """The shape-only route: the launch's copies of its inputs (padding,
    contiguity), empty outputs, and the call's work tallied."""
    B, Sq, H, D = q.shape
    call_work = work(q, k, v, causal, return_lse)
    width = _kernel_width(q, k, v)
    q = pad_head_dim(q, width).contiguous()
    for t in (k, v):
        pad_head_dim(t, width).contiguous()
    tally_work("flash_attention", *call_work)
    out = torch.empty_like(q)[..., :D]
    if not return_lse:
        return out
    return out, torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)


def _launch(q, k, v, causal: bool, return_lse: bool = False):
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    call_work = work(q, k, v, causal, return_lse)
    library = kernel_for(q, k, v)
    width = _kernel_width(q, k, v)
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention: all inputs on one CUDA device")
    q, k, v = (aligned16(pad_head_dim(t, width).contiguous())
               for t in (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out[..., :D], lse) if return_lse else out[..., :D]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _bind(library)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(),
                             lse.data_ptr() if return_lse else None,
                             B, Sq, Skv, H, Hkv, width,
                             int(causal), 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{build.launch_error(err)}")
    flash_attention.launches += 1
    tally_work("flash_attention", *call_work)
    out = out if width == D else out[..., :D]
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, causal: bool = True, return_lse: bool = False):
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D).  Returns (B, Sq, H, D) in
    q's dtype; with `return_lse`, (o, lse (B, H, Sq) f32 in natural-log
    units).  Raises ValueError when H % Hkv != 0 or the batch, head dim
    or K/V shapes disagree."""
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} disagree")
    if H % k.shape[2] != 0:
        raise ValueError(
            f"flash_attention: {H} query heads are not divisible by "
            f"{k.shape[2]} KV heads — GQA grouping needs H % Hkv == 0")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, return_lse=return_lse)
    if q.device.type == "meta":
        return _meta(q, k, v, causal, return_lse)
    return _launch(q, k, v, causal, return_lse)


flash_attention.launches = 0
