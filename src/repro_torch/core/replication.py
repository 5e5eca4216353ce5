"""Adaptive Weight Replication (paper §V-B, Algorithm 1) — a copy of
`repro.core.replication` (pure Python) for the port.

Given the rows freed after a layer's compute, decide which upcoming layers to
write next and with what replication factors.  Replicating a layer r× lets r
activation windows be processed concurrently (compute latency / r) at the
cost of r× the weight writes and rows.

The iterative branch (plenty of rows free) mirrors Algorithm 1: start from
the largest window of K consecutive layers that fits unreplicated, then
repeatedly *drop the last layer of the window* and hand its rows (plus any
spare) to the currently-slowest layers, until the window's interior compute
latency no longer exceeds the write latency WL of the following wave — the
inflection point beyond which more replication cannot help (computation would
finish before the next weights are ready anyway).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence


@dataclasses.dataclass(frozen=True)
class WriteItem:
    layer_idx: int
    replication: int     # ≥ 1; rows consumed = replication * base_rows
    rows: int            # total rows to allocate for this item
    fraction: float      # fraction of the layer's weights written (1.0 = full)


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Static per-layer quantities the planner needs."""

    base_rows: int            # rows for one replica
    compute_cycles: int       # unreplicated compute latency (windows * 96)
    max_replication: int      # typically min(windows, cap)
    write_dma_cycles: float = 0.0  # DMA cycles to write one replica


def _replicate_longest(
    candidates: List[int],
    costs: Sequence[LayerCost],
    factors: Dict[int, int],
    spare_rows: int,
    wl_gate: float,
) -> int:
    """Greedy: +1 replica to the slowest candidate while rows remain.

    ``wl_gate`` is the write latency WL of the wave that follows: once a
    layer's replicated compute latency drops to WL, further replication
    cannot improve the makespan (the machine will be waiting on writes
    anyway, §V-B) — so such layers stop being candidates.  This is also why
    FC-dominated DNNs (BERT) see zero replication: token counts are tiny, so
    compute is already far below WL (paper Fig 14).
    Returns leftover spare rows.
    """
    pool = list(candidates)

    def window_cycles() -> float:
        return sum(costs[i].compute_cycles / factors[i] for i in candidates)

    while pool:
        if wl_gate > 0 and window_cycles() <= wl_gate:
            break  # the wave already hides the next wave's writes
        # Current latency of each candidate given its factor.
        slowest = max(pool, key=lambda i: costs[i].compute_cycles / factors[i])
        cost = costs[slowest]
        f = factors[slowest]
        if wl_gate > 0:
            worthwhile = True
        else:
            # Tail wave: no following writes to hide behind — replicate while
            # the marginal compute saving beats the replica's own DMA cost.
            saving = cost.compute_cycles / f - cost.compute_cycles / (f + 1)
            worthwhile = saving > cost.write_dma_cycles
        if (
            not worthwhile
            or f >= cost.max_replication
            or cost.base_rows > spare_rows
        ):
            pool.remove(slowest)
            continue
        factors[slowest] += 1
        spare_rows -= cost.base_rows
    return spare_rows


def plan_writes(
    free_rows: int,
    next_idx: int,
    costs: Sequence[LayerCost],
    wl_cycles: Callable[[int], float],
    replication_enabled: bool = True,
) -> List[WriteItem]:
    """Algorithm 1: decide the next write wave.

    ``costs`` covers all layers; indices ≥ ``next_idx`` are unwritten.
    ``wl_cycles(idx)`` estimates the write latency of the wave that will
    follow a window ending at ``idx`` (the paper's WL threshold).
    """
    n = len(costs)
    if next_idx >= n or free_rows <= 0:
        return []

    L = next_idx
    need_l = costs[L].base_rows

    if free_rows < need_l:
        # Lines 2-3: partial write of L, never replicated.
        frac = free_rows / need_l
        return [WriteItem(L, 1, free_rows, frac)]

    next_need = costs[L + 1].base_rows if L + 1 < n else None
    if not replication_enabled:
        # Fit as many consecutive layers as possible, no replication.
        items, rows = [], free_rows
        i = L
        while i < n and rows >= costs[i].base_rows:
            items.append(WriteItem(i, 1, costs[i].base_rows, 1.0))
            rows -= costs[i].base_rows
            i += 1
        if i < n and rows > 0:
            items.append(WriteItem(i, 1, rows, rows / costs[i].base_rows))
        return items

    if next_need is None:
        # Final layer: replicate only while the marginal compute saving
        # beats the replica's own DMA cost (tail-wave gate).
        factors = {L: 1}
        _replicate_longest([L], costs, factors, free_rows - need_l,
                           wl_gate=0.0)
        return [WriteItem(L, factors[L], factors[L] * need_l, 1.0)]
    if free_rows < need_l + next_need:
        # Lines 4-5: only L fits entirely → replicate L into the free rows,
        # gated by the WL of the following wave.
        factors = {L: 1}
        _replicate_longest([L], costs, factors, free_rows - need_l,
                           wl_gate=wl_cycles(L + 1))
        return [WriteItem(L, factors[L], factors[L] * need_l, 1.0)]

    # Lines 6-17: iterative window shrinking.
    # K = number of consecutive layers that fit without replication.
    K, acc = 0, 0
    while L + K < n and acc + costs[L + K].base_rows <= free_rows:
        acc += costs[L + K].base_rows
        K += 1

    while True:
        window = list(range(L, L + K))
        factors = {i: 1 for i in window}
        spare = free_rows - sum(costs[i].base_rows for i in window)
        # WL of the wave following this window.  When nothing follows, any
        # compute reduction shows directly in the makespan → gate at 0.
        wl = wl_cycles(L + K) if L + K < n else 0.0
        _replicate_longest(window, costs, factors, spare, wl_gate=wl)
        interior = window[1:-1] if K > 2 else []
        interior_cycles = sum(
            costs[i].compute_cycles / factors[i] for i in interior
        )
        if K <= 2 or L + K >= n or interior_cycles <= wl:
            return [
                WriteItem(i, factors[i], factors[i] * costs[i].base_rows, 1.0)
                for i in window
            ]
        K -= 1
