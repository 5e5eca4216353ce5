"""Wrapper for the crossbar INT8 matmul: uint8 activation codes times
uint8 weight codes with the Eq. 7 zero-point correction, f32 out.

A CPU tensor goes to the plain PyTorch version (`ref.py`); a CUDA tensor
launches the hand-written kernel (`csrc/crossbar_mvm.cu`) or raises.  The
kernel's 8-bit tensor-core product reads both operands K-major, so each
call allocates scratch for one transposed copy of the weight codes (and,
for a ragged K, a zero-padded copy of the activations) that the kernel's
prep pass fills; their time is the kernel's.
`crossbar_mvm.launches` counts kernel launches and nothing else.
"""
import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.crossbar_mvm.ref import crossbar_mvm_plain

#: Largest K whose int32 sums cannot overflow: 255² · K < 2**31.
MAX_K = 33025


@functools.cache
def _bind():
    fn = build.load("crossbar_mvm").crossbar_mvm_u8
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def padded_k(K: int) -> int:
    """The row pitch of the kernel's K-major operands: K rounded up to 16
    bytes, the stride TMA accepts.  The padding is zeros."""
    return -(-K // 16) * 16


def tma_ready(x_codes: torch.Tensor) -> bool:
    """Whether TMA can read the (M, K) activation codes in place: rows 16
    bytes apart and the data 16-byte aligned.  Otherwise the kernel reads a
    zero-padded (M, padded_k(K)) copy that its prep pass writes."""
    return x_codes.shape[1] % 16 == 0 and x_codes.data_ptr() % 16 == 0


def scratch(x_codes: torch.Tensor, w_codes: torch.Tensor):
    """The per-call scratch of the kernel, on the inputs' device: the
    transposed weight codes Wᵀ (N, Kp) the 8-bit tensor cores read K-major,
    the row and column sums (M + N) int32, and the padded activation copy
    (M, Kp), or None when `tma_ready`."""
    (M, K), N = x_codes.shape, w_codes.shape[1]
    Kp = padded_k(K)
    dev = x_codes.device
    wt = torch.empty(N, Kp, dtype=torch.uint8, device=dev)
    sums = torch.empty(M + N, dtype=torch.int32, device=dev)
    xp = (None if tma_ready(x_codes)
          else torch.empty(M, Kp, dtype=torch.uint8, device=dev))
    return wt, sums, xp


def crossbar_mvm(x_codes: torch.Tensor, w_codes: torch.Tensor, zp_x, zp_w,
                 scale) -> torch.Tensor:
    """x_codes (M, K) uint8, w_codes (K, N) uint8; zp_x, zp_w and scale
    (= s_x·s_w) f32 scalars.  Returns the (M, N) f32 product
    (acc − zp_w·Σx − zp_x·Σw + K·zp_x·zp_w)·scale."""
    if x_codes.dtype != torch.uint8 or w_codes.dtype != torch.uint8 \
            or x_codes.ndim != 2 or w_codes.ndim != 2 \
            or x_codes.shape[1] != w_codes.shape[0]:
        raise ValueError(f"crossbar_mvm takes uint8 (M, K) and (K, N) codes; "
                         f"got {x_codes.dtype} {tuple(x_codes.shape)} and "
                         f"{w_codes.dtype} {tuple(w_codes.shape)}")
    M, K = x_codes.shape
    N = w_codes.shape[1]
    if K > MAX_K:
        raise ValueError(f"crossbar_mvm: K={K} > {MAX_K} would overflow the "
                         "int32 accumulator")
    if x_codes.device.type == "cpu":
        return crossbar_mvm_plain(x_codes, w_codes, zp_x, zp_w, scale)
    if not (w_codes.is_cuda and w_codes.device == x_codes.device):
        raise ValueError("crossbar_mvm: inputs on one CUDA device")
    out = torch.empty(M, N, dtype=torch.float32, device=x_codes.device)
    if out.numel() == 0:
        return out
    x_codes, w_codes = x_codes.contiguous(), w_codes.contiguous()
    wt, sums, xp = scratch(x_codes, w_codes)
    f32 = lambda v: float(np.float32(float(v)))  # noqa: E731
    stream = torch.cuda.current_stream(x_codes.device).cuda_stream
    with torch.cuda.device(x_codes.device):
        err = _bind()(x_codes.data_ptr(), w_codes.data_ptr(), out.data_ptr(),
                      wt.data_ptr(), None if xp is None else xp.data_ptr(),
                      sums.data_ptr(), M, K, N, f32(zp_x), f32(zp_w),
                      f32(scale), stream)
    if err != 0:
        raise RuntimeError(f"crossbar_mvm kernel launch failed: "
                           f"{build.launch_error(err)}")
    crossbar_mvm.launches += 1
    return out


crossbar_mvm.launches = 0
