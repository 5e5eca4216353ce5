"""Wrapper for the pulse-count kernel: programming pulses and unchanged
cells of an install (resident codes `old` overwritten by `new`).

The kernel leaves one int32 pair of partials per 32 KiB block, as the
Pallas grid does; they are summed here in int64.  At a gemma-7b layer's
1.1e9 cells the pulses can pass 2**31, where the reference's int32 total
wraps; the port's int64 totals equal the reference's wherever it does not
wrap (and numpy's `flip_counts` everywhere).

A CPU tensor goes to the plain PyTorch version (`ref.py`); a CUDA tensor
launches the hand-written kernel (`csrc/pulse_count.cu`) or raises.
`pulse_count.launches` counts kernel launches and nothing else.
"""
import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.pulse_count.ref import pulse_count_plain


@functools.cache
def _bind():
    lib = build.load("pulse_count")
    fn = lib.pulse_count_u8
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    blocks = lib.pulse_count_blocks
    blocks.argtypes = [ctypes.c_longlong]
    blocks.restype = ctypes.c_longlong
    return fn, blocks


def pulse_count(old: torch.Tensor, new: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 old and new of one shape -> (pulses, unchanged cells) as int64
    0-dim tensors on their device (no host sync)."""
    if old.dtype != torch.uint8 or new.dtype != torch.uint8 \
            or old.shape != new.shape:
        raise ValueError(f"pulse_count takes uint8 codes of one shape; got "
                         f"{old.dtype} {tuple(old.shape)} and {new.dtype} "
                         f"{tuple(new.shape)}")
    if old.device.type == "cpu":
        return pulse_count_plain(old, new)
    if not (new.is_cuda and new.device == old.device
            and old.is_contiguous() and new.is_contiguous()):
        raise ValueError("pulse_count: contiguous inputs on one CUDA device")
    fn, blocks = _bind()
    n = old.numel()
    parts = torch.zeros(2, max(int(blocks(n)), 1), dtype=torch.int32,
                        device=old.device)
    aligned = old.data_ptr() % 16 == 0 and new.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(old.device).cuda_stream
    with torch.cuda.device(old.device):
        err = fn(old.data_ptr(), new.data_ptr(), n, int(aligned),
                 parts[0].data_ptr(), parts[1].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pulse_count kernel launch failed: cudaError {err}")
    pulse_count.launches += 1
    totals = parts.sum(dim=1, dtype=torch.int64)
    return totals[0], totals[1]


pulse_count.launches = 0
