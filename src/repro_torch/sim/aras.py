"""Event-driven simulator of the ARAS accelerator (paper §VI).

Models the paper's machine: a pool of 96 PEs × 6×4 APUs with 128×128 2-bit
crossbars, an LPDDR4 main memory (19.2 GB/s, serialized DMA), a heterogeneous
multi-banked Global Buffer, and the ARAS offline scheduler that overlaps the
compute of layer L with the weight writing of layers L+1…L+K (Fig 8),
including Algorithm-1 replication and §V-C partial weight reuse.

The same simulation doubles as the *offline scheduler*: with
``record_instructions=True`` it emits the static instruction stream
(write/compute ops with resources, replication factors and timestamps) that
the paper's Fig 6 flow would hand to the hardware.

The port's copy of `repro.sim.aras`.  The event loop is the reference's
host Python over numpy float64, unchanged: it is control flow over tens to
hundreds of segments, and every value it computes equals the reference's.
The one pass over the weights is `encode_network`'s, which counts each
layer's 256-bin code histogram on the device that holds the codes.  Every
time and energy here is a model output of the paper's simulated machine,
not a measurement of the device the port runs on.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bank_selection import Bank, BankSelection, make_banks, select_banks
from repro_torch.core.layer_graph import LayerGraph, LayerNode
from repro_torch.core.replication import LayerCost, plan_writes
from repro_torch.core.resources import AcceleratorConfig
from repro_torch.core.weight_reuse import (
    ERASED_HIST,
    LayerEncoding,
    encode_network,
    expected_pulses_per_weight,
)
from repro_torch.sim.energy import EnergyModel
from repro_torch.xbar.cells import CELLS_PER_WEIGHT

BASELINE_BANKS_BYTES = tuple([256 * 1024] * 15)
HETERO_BANKS_BYTES = (
    1024, 1024, 2 * 1024, 4 * 1024, 64 * 1024, 128 * 1024,
    256 * 1024, 512 * 1024, 1024 * 1024, 2 * 1024 * 1024,
)


@dataclasses.dataclass(frozen=True)
class ArasSimConfig:
    accel: AcceleratorConfig = AcceleratorConfig()
    energy: EnergyModel = EnergyModel()
    overlap: bool = True          # ARAS scheduler (Fig 8) vs naive (Fig 7)
    replication: bool = False     # §V-B
    hetero_banks: bool = False    # §V-A
    weight_reuse: bool = False    # §V-C
    max_replication: int = 64
    record_instructions: bool = False

    @staticmethod
    def variant(name: str, **kw) -> "ArasSimConfig":
        """Paper configurations: naive | baseline | B | BR | BRW."""
        presets = {
            "naive": dict(overlap=False),
            "baseline": dict(overlap=True),
            "B": dict(overlap=True, hetero_banks=True),
            "BR": dict(overlap=True, hetero_banks=True, replication=True),
            "BRW": dict(overlap=True, hetero_banks=True, replication=True,
                        weight_reuse=True),
        }
        return ArasSimConfig(**{**presets[name], **kw})


@dataclasses.dataclass(frozen=True)
class Segment:
    """A schedulable unit: a layer, or a column-wise slice of a large layer."""

    layer_idx: int
    seg_idx: int
    name: str
    kernel_volume: int
    num_kernels: int
    windows: int
    apus: int           # APUs for one replica
    base_rows: int      # PE rows for one replica
    weights: int

    @property
    def compute_cycles_unreplicated(self) -> int:
        return self.windows  # multiplied by xbar_compute_cycles by the engine


@dataclasses.dataclass
class Instruction:
    kind: str            # 'write' | 'compute'
    segment: str
    t_start_cycles: float
    t_end_cycles: float
    rows: int
    replication: int
    fraction: float = 1.0


@dataclasses.dataclass
class SimResult:
    name: str
    makespan_s: float
    energy: Dict[str, float]
    total_pulses: float
    weights_written: float
    cell_writes_per_inference: float
    upper_bound_s: Optional[float]
    instructions: List[Instruction]
    reuse_center: Optional[int]
    per_layer_compute_s: Dict[str, float]

    @property
    def throughput_inf_s(self) -> float:
        return 1.0 / self.makespan_s

    @property
    def total_energy_j(self) -> float:
        return self.energy["total"]


def segment_graph(graph: LayerGraph, accel: AcceleratorConfig) -> List[Segment]:
    """Split layers that exceed the crossbar pool into column-slices (§IV-A:
    'In the event that a layer exceeds the capacity of the accelerator, it is
    divided into smaller segments, each of which is executed sequentially')."""
    segs: List[Segment] = []
    spec = accel.xbar
    for li, layer in enumerate(graph.layers):
        m = layer.mapping(spec)
        total_rows = accel.rows_for_apus(m.apus)
        if total_rows <= accel.total_rows:
            segs.append(Segment(li, 0, layer.name, layer.kernel_volume,
                                layer.num_kernels, layer.windows, m.apus,
                                total_rows, layer.weights))
            continue
        # Split along kernels (output channels) in groups that fit the pool.
        kernels_per_colgroup = spec.weights_per_row
        apus_per_colgroup = m.xbars_tall
        rows_per_colgroup = accel.rows_for_apus(apus_per_colgroup)
        groups_per_seg = max(accel.total_rows // rows_per_colgroup, 1)
        kernels_per_seg = groups_per_seg * kernels_per_colgroup
        n_segs = math.ceil(layer.num_kernels / kernels_per_seg)
        done = 0
        for si in range(n_segs):
            k = min(kernels_per_seg, layer.num_kernels - done)
            done += k
            mm = math.ceil(k / kernels_per_colgroup) * apus_per_colgroup
            segs.append(Segment(li, si, f"{layer.name}.s{si}",
                                layer.kernel_volume, k, layer.windows, mm,
                                accel.rows_for_apus(mm),
                                layer.kernel_volume * k))
    return segs


class _Dram:
    """Serialized DMA channel (single LPDDR4 channel, paper §VI)."""

    def __init__(self, bytes_per_cycle: float):
        self.bpc = bytes_per_cycle
        self.free_at = 0.0
        self.bytes_moved = 0.0

    def transfer(self, t: float, nbytes: float) -> float:
        start = max(t, self.free_at)
        end = start + nbytes / self.bpc
        self.free_at = end
        self.bytes_moved += nbytes
        return end


class _Occupancy:
    """FIFO of (rows, hist) chunks tracking which layer's codes currently sit
    in each crossbar row — determines overwrite pulse costs."""

    def __init__(self, total_rows: int):
        self.chunks = deque([(total_rows, None)])  # None = erased

    def consume(self, rows: int) -> List[Tuple[int, Optional[np.ndarray]]]:
        out: List[Tuple[int, Optional[np.ndarray]]] = []
        need = rows
        while need > 0:
            r, h = self.chunks.popleft()
            take = min(r, need)
            out.append((take, h))
            if r > take:
                self.chunks.appendleft((r - take, h))
            need -= take
        return out

    def release(self, rows: int, hist: np.ndarray) -> None:
        self.chunks.append((rows, hist))


def _bank_plans(
    graph: LayerGraph, hetero: bool, energy: EnergyModel
) -> Tuple[List[Bank], Dict[int, BankSelection], Dict[int, float]]:
    sizes = HETERO_BANKS_BYTES if hetero else BASELINE_BANKS_BYTES
    banks = make_banks(sizes, energy.sram_leak_w_per_kb, energy.sram_bank_overhead_w)
    sel: Dict[int, BankSelection] = {}
    in_leak: Dict[int, float] = {}
    for li, layer in enumerate(graph.layers):
        sel[li] = select_banks(banks, layer.in_act_bytes, layer.out_act_bytes)
        # Leakage of just holding the layer's input (gaps between computes).
        hold = select_banks(banks, layer.in_act_bytes, 0)
        in_leak[li] = hold.leakage_w
    return banks, sel, in_leak


def simulate_aras(
    graph: LayerGraph,
    layer_codes: Sequence[Tuple[str, torch.Tensor]],
    config: ArasSimConfig = ArasSimConfig(),
) -> SimResult:
    accel, em = config.accel, config.energy
    segs = segment_graph(graph, accel)
    n = len(segs)
    bpc = accel.dram_bw_effective / accel.freq_hz  # bytes per cycle

    encodings, center = encode_network(layer_codes, enabled=config.weight_reuse)
    hist_of_layer = [e.hist for e in encodings]

    banks, bank_sel, bank_in_leak = _bank_plans(graph, config.hetero_banks, em)

    segmented_layers = {s.layer_idx for s in segs if s.seg_idx > 0}
    costs = [
        LayerCost(
            base_rows=s.base_rows,
            compute_cycles=s.windows * accel.xbar_compute_cycles,
            max_replication=(
                1 if s.layer_idx in segmented_layers
                else min(s.windows, config.max_replication)
            ),
            write_dma_cycles=s.weights / bpc,
        )
        for s in segs
    ]

    def wl_cycles(idx: int) -> float:
        if idx >= n:
            return float("inf")
        dram_cycles = segs[idx].weights / bpc
        return max(accel.xbar_write_cycles, dram_cycles)

    dram = _Dram(bpc)
    occ = _Occupancy(accel.total_rows)
    free_rows = accel.total_rows

    ready: Dict[int, float] = {}       # seg -> fully-written time
    rows_of: Dict[int, int] = {}
    repl_of: Dict[int, int] = {i: 1 for i in range(n)}
    frac_written: Dict[int, float] = {i: 0.0 for i in range(n)}
    part_rows: Dict[int, int] = {i: 0 for i in range(n)}

    total_pulses = 0.0
    weights_written = 0.0
    instructions: List[Instruction] = []

    def _write_chunk(t: float, seg: Segment, rows: int, frac: float, repl: int) -> float:
        nonlocal total_pulses, weights_written, free_rows
        nbytes = seg.weights * frac * repl
        dram_end = dram.transfer(t, nbytes)
        end = max(t + accel.xbar_write_cycles, dram_end)
        free_rows -= rows
        new_hist = hist_of_layer[seg.layer_idx]
        for r, old_hist in occ.consume(rows):
            share = (r / rows) * seg.weights * frac * repl
            old = ERASED_HIST if old_hist is None else old_hist
            total_pulses += share * expected_pulses_per_weight(old, new_hist)
        weights_written += seg.weights * frac * repl
        if config.record_instructions:
            instructions.append(Instruction("write", seg.name, t, end, rows, repl, frac))
        return end

    w = 0  # next segment index to plan writes for

    def plan_and_issue(t: float, max_seg: Optional[int] = None) -> None:
        """Weight Writing Scheduling Procedure (Fig 9b).  ``max_seg`` bounds
        the write frontier — the naive Fig-7 scheduler only ever writes the
        segment it is about to compute."""
        nonlocal w, free_rows
        while w < n and free_rows > 0:
            if max_seg is not None and w > max_seg:
                return
            eff = list(costs)
            if frac_written[w] > 0.0:
                rem = 1.0 - frac_written[w]
                eff[w] = LayerCost(
                    base_rows=max(segs[w].base_rows - part_rows[w], 1),
                    compute_cycles=costs[w].compute_cycles,
                    max_replication=1,
                )
            items = plan_writes(free_rows, w, eff, wl_cycles,
                                replication_enabled=config.replication)
            if max_seg is not None:
                items = [it for it in items if it.layer_idx <= max_seg]
            if not items:
                return
            for it in items:
                s = segs[it.layer_idx]
                if it.fraction >= 1.0 and frac_written[it.layer_idx] == 0.0:
                    end = _write_chunk(t, s, it.rows, 1.0, it.replication)
                    ready[it.layer_idx] = end
                    rows_of[it.layer_idx] = it.rows
                    repl_of[it.layer_idx] = it.replication
                    frac_written[it.layer_idx] = 1.0
                    w = it.layer_idx + 1
                else:
                    # Partial (continuation) write of segment ``it.layer_idx``.
                    idx = it.layer_idx
                    frac = min(it.fraction * (1.0 - frac_written[idx])
                               if frac_written[idx] > 0.0 else it.fraction,
                               1.0 - frac_written[idx])
                    end = _write_chunk(t, s, it.rows, frac, 1)
                    frac_written[idx] += frac
                    part_rows[idx] += it.rows
                    rows_of[idx] = part_rows[idx]
                    if frac_written[idx] >= 1.0 - 1e-9:
                        ready[idx] = end
                        w = idx + 1
                    else:
                        ready[idx] = float("inf")
            if any(it.fraction < 1.0 for it in items):
                return  # pool exhausted on a partial chunk

    # --- initial input DMA (initialization state, Fig 9a) ---
    input_dma_end = dram.transfer(0.0, graph.layers[0].in_act_bytes)

    gbuffer_j = 0.0
    compute_j = 0.0
    sram_j = 0.0
    per_layer_compute_s: Dict[str, float] = {}

    comp_end_prev = 0.0
    if config.overlap:
        plan_and_issue(0.0)
    for c in range(n):
        seg = segs[c]
        max_seg = None if config.overlap else c
        if not config.overlap:
            # Naive Fig 7: write strictly before this segment's compute, and
            # never write ahead.
            plan_and_issue(comp_end_prev, max_seg)
        guard = 0
        while frac_written[c] < 1.0 - 1e-9:
            plan_and_issue(max(comp_end_prev, ready.get(c, 0.0)
                               if ready.get(c, 0.0) != float("inf") else comp_end_prev),
                           max_seg)
            guard += 1
            if guard > 10000:
                raise RuntimeError(f"scheduler stuck on segment {seg.name}")
        start = max(ready[c], comp_end_prev)
        if c == 0:
            start = max(start, input_dma_end)
        dur = math.ceil(seg.windows / repl_of[c]) * accel.xbar_compute_cycles
        end = start + dur
        li = seg.layer_idx
        gap = start - comp_end_prev
        gbuffer_j += bank_in_leak[li] * accel.cycles_to_seconds(gap)
        gbuffer_j += bank_sel[li].leakage_w * accel.cycles_to_seconds(dur)
        compute_j += seg.windows * seg.apus * em.xbar_op_j
        sram_j += seg.windows * (seg.kernel_volume + seg.num_kernels) * em.sram_access_j_per_byte
        per_layer_compute_s[seg.name] = accel.cycles_to_seconds(dur)
        if config.record_instructions:
            instructions.append(Instruction("compute", seg.name, start, end,
                                            rows_of[c], repl_of[c]))
        # Release state: free this segment's rows and immediately bind writes.
        free_rows += rows_of[c]
        occ.release(rows_of[c], hist_of_layer[li])
        comp_end_prev = end
        if config.overlap:
            plan_and_issue(end)

    makespan_cycles = dram.transfer(comp_end_prev, graph.layers[-1].out_act_bytes)
    makespan_s = accel.cycles_to_seconds(makespan_cycles)

    write_j = total_pulses * em.write_pulse_j
    dram_j = dram.bytes_moved * em.dram_j_per_byte
    static_other_w = em.chip_other_leak_w + accel.total_apus * em.apu_leak_w
    static_other_j = static_other_w * makespan_s
    energy = {
        "write": write_j,
        "static_gbuffer": gbuffer_j,
        "static_other": static_other_j,
        "compute": compute_j,
        "sram": sram_j,
        "dram": dram_j,
    }
    energy["total"] = sum(energy.values())

    return SimResult(
        name=graph.name,
        makespan_s=makespan_s,
        energy=energy,
        total_pulses=total_pulses,
        weights_written=weights_written,
        cell_writes_per_inference=weights_written / accel.weight_capacity,
        upper_bound_s=None,
        instructions=instructions,
        reuse_center=center,
        per_layer_compute_s=per_layer_compute_s,
    )


def upper_bound_cycles(graph: LayerGraph, accel: AcceleratorConfig) -> float:
    """Performance upper bound (§VII-B): the time to write every layer's
    weights exactly once given the pool and DRAM constraints, with compute
    taken as free (rows release instantly)."""
    segs = segment_graph(graph, accel)
    bpc = accel.dram_bw_effective / accel.freq_hz
    dram = _Dram(bpc)
    t = 0.0
    free_rows = accel.total_rows
    pending: deque = deque()  # (end_time, rows)
    for s in segs:
        rows_left = s.base_rows
        while rows_left > 0:
            while free_rows == 0:
                end, r = pending.popleft()
                t = max(t, end)
                free_rows += r
            take = min(rows_left, free_rows)
            frac = take / s.base_rows
            end = max(t + accel.xbar_write_cycles, dram.transfer(t, s.weights * frac))
            free_rows -= take
            pending.append((end, take))
            rows_left -= take
    return max(e for e, _ in pending) if pending else t
