"""Wrapper for the paged-attention decode kernel: groups query heads per KV
head (GQA stays native — no pool expansion).

A CPU tensor goes to the plain PyTorch version (`ref.py`); a CUDA tensor
launches the hand-written kernel (`csrc/paged_attention.cu`) or raises.
`paged_attention.launches` counts kernel launches and nothing else.
"""
import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_plain


@functools.cache
def _bind():
    fn = build.load("paged_attention").paged_attention_bf16
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_pool, v_pool, tables, pos) -> torch.Tensor:
    B, H, D = q.shape
    P, page, Hkv, _ = k_pool.shape
    T = tables.shape[1]
    if not q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16:
        raise ValueError(
            f"paged_attention kernel takes bf16 q and pools; got "
            f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if D not in (32, 64, 128, 256) or H // Hkv > 8:
        raise ValueError(f"paged_attention kernel needs head_dim in 32, 64, "
                         f"128, 256 and at most 8 query heads per KV head; "
                         f"got D={D}, G={H // Hkv}")
    for t in (q, k_pool, v_pool, tables, pos):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("paged_attention: all inputs on one CUDA device")
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), v_pool.contiguous()
    tables = tables.contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _bind()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, Hkv, H // Hkv, D, P, page, T, 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    paged_attention.launches += 1
    return out


def paged_attention(q, k_pool, v_pool, tables, pos) -> torch.Tensor:
    """q: (B, H, D) one query token per row, heads in KV-major order (head
    h serves KV head h // (H/Hkv)); k/v_pool: (P, page, Hkv, D) page pools;
    tables: (B, T) int32 physical page ids; pos: (B,) per-row positions.
    Returns (B, H, D) in q's dtype.

    Raises ValueError on a head count H not divisible by Hkv, or on a
    non-int32 page table (a float table would truncate page ids)."""
    H = q.shape[1]
    Hkv = k_pool.shape[2]
    if H % Hkv != 0:
        raise ValueError(
            f"paged_attention: {H} query heads are not divisible by "
            f"{Hkv} KV heads — GQA grouping needs H % Hkv == 0")
    if tables.dtype != torch.int32:
        raise ValueError(
            f"paged_attention: page table dtype {tables.dtype} must be "
            "int32 (physical page ids)")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, tables, pos)
    return _launch(q, k_pool, v_pool, tables, pos)


paged_attention.launches = 0
