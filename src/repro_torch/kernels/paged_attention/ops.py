"""Wrapper for the paged-attention decode kernel: groups query heads per KV
head (GQA stays native — no pool expansion).

A CPU tensor goes to the plain PyTorch version (`ref.py`); a CUDA tensor
launches the hand-written split-row kernel (`csrc/paged_attention.cu`) or
raises.  One call is one launch: the last split of a row to finish merges
the row's splits, so there is no second kernel.
`paged_attention.launches` counts kernel launches and nothing else.
"""
import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import aligned16, build
from repro_torch.kernels.paged_attention.ref import paged_attention_plain


def check_contract(head_dim: int, group: int) -> None:
    """Raise ValueError unless the kernel takes this head dim (a multiple
    of 8 from 8 to 256) and this many query heads per KV head (1 to 16)."""
    if head_dim % 8 or not 8 <= head_dim <= 256:
        raise ValueError(f"paged_attention kernel needs a head_dim that is "
                         f"a multiple of 8 from 8 to 256; got {head_dim}")
    if not 1 <= group <= 16:
        raise ValueError(f"paged_attention kernel takes 1 to 16 query heads "
                         f"per KV head; got {group}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    lib.paged_attention_bf16.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_attention_bf16.restype = ctypes.c_int
    lib.paged_attention_plan.argtypes = (
        [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)])
    lib.paged_attention_plan.restype = ctypes.c_int
    return lib


@functools.cache
def split_plan(table_width: int, page: int, rows: int, group: int,
               head_dim: int, device: torch.device) -> Tuple[int, ...]:
    """(splits, pages per split, f32 elements of the two merge scratch
    buffers, tickets) of a call over `rows` (row, KV head) pairs whose
    table holds `table_width` pages, as the kernel library plans it
    (`paged_attention_plan` in the source) for the device's SM count.
    From the shapes only, never from the positions, which live on the
    device."""
    plan = (ctypes.c_longlong * 5)()
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    err = _lib().paged_attention_plan(table_width, page, rows, group,
                                      head_dim, n_sms, plan)
    if err != 0:
        raise ValueError(f"paged_attention: no split plan for T "
                         f"{table_width}, page {page}, {rows} rows "
                         f"(cudaError {err})")
    return tuple(plan)


_tickets = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least `n` zeroed uint32 tickets for launches on `stream`: the
    kernel leaves every ticket it takes at 0 again, so one buffer serves
    every call on that stream (calls on one stream run one after
    another)."""
    key = (device, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


def _launch(q, k_pool, v_pool, tables, pos) -> torch.Tensor:
    B, H, D = q.shape
    P, page, Hkv, _ = k_pool.shape
    T = tables.shape[1]
    if not q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16:
        raise ValueError(
            f"paged_attention kernel takes bf16 q and pools; got "
            f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    check_contract(D, H // Hkv)
    if T < 1:
        raise ValueError("paged_attention: the page table has no column")
    for t in (q, k_pool, v_pool, tables, pos):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("paged_attention: all inputs on one CUDA device")
    q, k_pool, v_pool = (aligned16(t.contiguous())
                         for t in (q, k_pool, v_pool))
    tables = tables.contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    G = H // Hkv
    n_split, chunk_pages, n_part, n_part_ml, n_tickets = split_plan(
        T, page, B * Hkv, G, D, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch = [0, 0, 0]
    if n_split > 1:
        part = torch.empty(n_part, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(n_part_ml, dtype=torch.float32,
                              device=q.device)
        scratch = [part.data_ptr(), part_ml.data_ptr(),
                   _counters(q.device, stream, n_tickets).data_ptr()]
    with torch.cuda.device(q.device):
        err = _lib().paged_attention_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(), *scratch,
            B, Hkv, G, D, page, T, n_split, chunk_pages,
            1.0 / math.sqrt(D), stream)
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
    non-int32 page table (a float table would truncate page ids); on a
    CUDA tensor also outside the kernel's contract (`check_contract`)."""
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
