"""Wrapper for the delta-apply kernel: `(old + delta) mod 256` on uint8
codes — the device half of a weight install.

A CPU tensor goes to the plain PyTorch version (`ref.py`); a CUDA tensor
launches the hand-written kernel (`csrc/delta_apply.cu`) or raises.
`apply_delta.launches` counts kernel launches and nothing else.
"""
import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.delta_apply.ref import delta_apply_plain


@functools.cache
def _bind():
    fn = build.load("delta_apply").delta_apply_u8
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def apply_delta(old: torch.Tensor, delta: torch.Tensor, *,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 old and delta of one shape -> (old + delta) mod 256.  With
    `out` (which may be `old` or `delta` itself: the update is elementwise)
    the result is written there and returned; otherwise into a new tensor.
    On the card every tensor starts on a 16-byte boundary, as the
    allocator's tensors do: the kernel moves 16 bytes per access and only
    the n % 16 tail bytewise."""
    if old.dtype != torch.uint8 or delta.dtype != torch.uint8 \
            or old.shape != delta.shape:
        raise ValueError(f"apply_delta takes uint8 codes and deltas of one "
                         f"shape; got {old.dtype} {tuple(old.shape)} and "
                         f"{delta.dtype} {tuple(delta.shape)}")
    if out is not None and (out.dtype != torch.uint8
                            or out.shape != old.shape):
        raise ValueError("apply_delta: out must be uint8 of old's shape")
    if old.device.type == "cpu":
        res = delta_apply_plain(old, delta)
        return res if out is None else out.copy_(res)
    for t in (old, delta) + ((out,) if out is not None else ()):
        if not t.is_cuda or t.device != old.device or not t.is_contiguous():
            raise ValueError("apply_delta: contiguous inputs on one CUDA "
                             "device")
    if out is None:
        out = torch.empty_like(old)
    if any(t.data_ptr() % 16 for t in (old, delta, out)):
        raise ValueError("apply_delta: CUDA tensors must start on a 16-byte "
                         "boundary")
    stream = torch.cuda.current_stream(old.device).cuda_stream
    with torch.cuda.device(old.device):
        err = _bind()(old.data_ptr(), delta.data_ptr(), out.data_ptr(),
                      old.numel(), stream)
    if err != 0:
        raise RuntimeError(f"delta_apply kernel launch failed: cudaError {err}")
    apply_delta.launches += 1
    return out


apply_delta.launches = 0
