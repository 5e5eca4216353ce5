"""Wrapper for the flash-attention forward kernel (prefill attention).

GQA-native: q (B, Sq, H, D) attends over k/v (B, Skv, Hkv, D) with query
head h reading KV head h // (H / Hkv).  A CPU tensor goes to the plain
PyTorch version (`ref.py`); a CUDA tensor launches a hand-written kernel
or raises: bf16 the tensor-core kernel (`csrc/flash_attention.cu`), f32
the CUDA-core kernel (`csrc/flash_attention_f32.cu`, full f32 products:
TF32 would not hold the reference's 3e-4).  `flash_attention.launches`
counts kernel launches, of either kernel, and nothing else.

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

from repro_torch.kernels import aligned16, build
from repro_torch.kernels.flash_attention.ref import flash_attention_plain


@functools.cache
def _bind(library: str = "flash_attention"):
    symbol = ("flash_attention_f32" if library == "flash_attention_f32"
              else "flash_attention_bf16")
    fn = getattr(build.load(library), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
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


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    library = kernel_for(q, k, v)
    width = native_head_dim(D)             # raises outside the contract
    if library == "flash_attention_f32":
        width = D                          # every such width is native
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention: all inputs on one CUDA device")
    q, k, v = (aligned16(pad_head_dim(t, width).contiguous())
               for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :D]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _bind(library)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), B, Sq, Skv, H, Hkv, width,
                             int(causal), 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{build.launch_error(err)}")
    flash_attention.launches += 1
    return out if width == D else out[..., :D]


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D).  Returns (B, Sq, H, D) in
    q's dtype.  Raises ValueError when H % Hkv != 0 or the batch, head dim
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
        return flash_attention_plain(q, k, v, causal)
    return _launch(q, k, v, causal)


flash_attention.launches = 0
