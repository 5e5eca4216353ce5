"""Wrapper for the paged-attention decode kernel: groups query heads per KV
head (GQA stays native — no pool expansion).

A CPU tensor goes to the plain PyTorch version (`ref.py`); a CUDA tensor
launches a hand-written split-row kernel or raises: bf16 the tensor-core
kernel (`csrc/paged_attention.cu`), f32 the CUDA-core kernel
(`csrc/paged_attention_f32.cu`, full f32 products on the same split-row
layout with its own split plan: decode is bytes-bound, so f32 FMAs keep
up with the memory).  One call is one launch: the last split of a row to
finish merges the row's splits, so there is no second kernel.
`paged_attention.launches` counts kernel launches, of either kernel, and
nothing else.

A `meta` tensor (the dry run's shape-only count) takes neither: the
wrapper returns an empty output of the kernel's shape and dtype and adds
the call's work (`work`) to the open tally (`repro_torch.kernels.counting`),
as a CUDA launch adds the same formula's.  Any other device raises.
"""
import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import aligned16, build, nbytes, tally_work
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


def kernel_for(q, k_pool, v_pool) -> str:
    """The kernel library that takes these inputs: "paged_attention" for
    bf16 q and pools, "paged_attention_f32" for f32.  Raises ValueError on
    any other dtype or a mix."""
    dtypes = {q.dtype, k_pool.dtype, v_pool.dtype}
    if dtypes == {torch.bfloat16}:
        return "paged_attention"
    if dtypes == {torch.float32}:
        return "paged_attention_f32"
    raise ValueError(
        f"paged_attention kernels take bf16 or f32 q and pools of one "
        f"dtype; got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")


# each library's (kernel, split planner) symbols
_SYMBOLS = {
    "paged_attention": ("paged_attention_bf16", "paged_attention_plan"),
    "paged_attention_f32": ("paged_attention_f32", "paged_attention_f32_plan"),
}


@functools.cache
def _lib(library: str = "paged_attention"):
    """The library's (kernel, planner) functions, bound.  Both kernels
    take the same arguments."""
    kernel_sym, plan_sym = _SYMBOLS[library]
    lib = build.load(library)
    kernel, plan = getattr(lib, kernel_sym), getattr(lib, plan_sym)
    kernel.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    kernel.restype = ctypes.c_int
    plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    plan.restype = ctypes.c_int
    return kernel, plan


@functools.cache
def split_plan(table_width: int, page: int, rows: int, group: int,
               head_dim: int, device: torch.device,
               library: str = "paged_attention") -> Tuple[int, ...]:
    """(splits, pages per split, f32 elements of the two merge scratch
    buffers, tickets) of a call over `rows` (row, KV head) pairs whose
    table holds `table_width` pages, as the kernel library plans it
    (`paged_attention_plan`, or `paged_attention_f32_plan` for
    library "paged_attention_f32", in the sources) for the device's SM
    count.  From the shapes only, never from the positions, which live on
    the device."""
    plan = (ctypes.c_longlong * 5)()
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    err = _lib(library)[1](table_width, page, rows, group, head_dim, n_sms,
                           plan)
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


def work(q, k_pool, v_pool, tables, pos):
    """(flops, bytes) of one call, counted over every position the page
    tables name (the whole cache, as the reference's XLA path reads it):
    4·H·D a position a row, each named page's K and V read once, q, the
    tables and pos read, o written."""
    B, H, D = q.shape
    page, Hkv = k_pool.shape[1], k_pool.shape[2]
    positions = B * tables.shape[1] * page
    kv = positions * Hkv * D * (k_pool.element_size() + v_pool.element_size())
    return 4 * H * D * positions, kv + 2 * nbytes(q) + nbytes(tables, pos)


def _meta(q, k_pool, v_pool, tables, pos) -> torch.Tensor:
    """The shape-only route: the launch's copies of its inputs
    (contiguity), an empty output, and the call's work tallied."""
    call_work = work(q, k_pool, v_pool, tables, pos)
    q = q.contiguous()
    for t in (k_pool, v_pool, tables):
        t.contiguous()
    pos.to(torch.int32).contiguous()
    tally_work("paged_attention", *call_work)
    return torch.empty_like(q)


def _launch(q, k_pool, v_pool, tables, pos) -> torch.Tensor:
    B, H, D = q.shape
    call_work = work(q, k_pool, v_pool, tables, pos)
    P, page, Hkv, _ = k_pool.shape
    T = tables.shape[1]
    library = kernel_for(q, k_pool, v_pool)
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_split, chunk_pages, n_part, n_part_ml, n_tickets = split_plan(
        T, page, B * Hkv, G, D, q.device, library)
    scratch = [0, 0, 0]
    if n_split > 1:
        part = torch.empty(n_part, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(n_part_ml, dtype=torch.float32,
                              device=q.device)
        scratch = [part.data_ptr(), part_ml.data_ptr(),
                   _counters(q.device, stream, n_tickets).data_ptr()]
    with torch.cuda.device(q.device):
        err = _lib(library)[0](
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(), *scratch,
            B, Hkv, G, D, page, T, n_split, chunk_pages,
            1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    paged_attention.launches += 1
    tally_work("paged_attention", *call_work)
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
    if q.device.type == "meta":
        return _meta(q, k_pool, v_pool, tables, pos)
    return _launch(q, k_pool, v_pool, tables, pos)


paged_attention.launches = 0
