"""Static streaming schedule: the ARAS offline scheduler retargeted at a
device-HBM weight arena — a copy of `repro.streaming.plan` (pure Python)
for the port, with the link model of one NVIDIA H100 in place of the
reference's TPU figures.

Resource mapping:
    crossbar rows  → arena slots (fixed-size HBM bins)
    ReRAM row write→ host→device DMA of a layer's INT8 (delta) stream
    write latency  → bytes / dma_bw  (+ fixed launch latency)
    compute latency→ per-layer roofline max(FLOPs/peak, bytes/hbm_bw)

The wave logic is the paper's: compute layer-by-layer; whenever slots free
up, Algorithm 1 (`repro_torch.core.replication.plan_writes`) decides which
coming layers to install, replicated if they are compute-bound relative to
the next wave's install latency WL.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core.replication import LayerCost, plan_writes

# Host-to-device copy rate and latency from pinned memory on the H100
# (see `LinkModel`).
DMA_BYTES_PER_S = 45.07e9
DMA_LATENCY_S = 26.68e-6


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One NVIDIA H100 SXM (80 GB HBM3, 700 W) for planning purposes.

    peak_flops and hbm_bw are the data sheet's dense bf16 tensor-core peak
    and HBM3 bandwidth.  dma_bw and dma_latency_s are host-to-device copies
    from pinned memory (a 277 MB copy, and a 4 KB one) as `chip_smoke.py`
    measured them on an H100 80GB HBM3 at a 700 W power limit; the rate
    varied from 45 to 54 GB/s between machines, so `chip_smoke.py` plans
    with its own measurement.
    """

    peak_flops: float = 989e12
    hbm_bw: float = 3.35e12
    dma_bw: float = DMA_BYTES_PER_S
    dma_latency_s: float = DMA_LATENCY_S


@dataclasses.dataclass(frozen=True)
class InstallCostModel:
    """Wire bytes → install latency, shared between the static StreamPlan
    (continuous seconds) and the serving engine's InstallPipeline (integer
    ticks — one tick is the DMA work a single decode step can hide).

    The two views model the same link: `install_s` is the StreamPlan's
    bandwidth + fixed-launch-latency cost, `ticks_for` quantizes the same
    stream into per-step budget units so a simulated-time engine can account
    overlap without a device clock."""

    bytes_per_s: float = DMA_BYTES_PER_S
    latency_s: float = DMA_LATENCY_S
    bytes_per_tick: int = 1 << 16

    def install_s(self, wire_bytes: float, replication: int = 1) -> float:
        return wire_bytes * replication / self.bytes_per_s + self.latency_s

    def ticks_for(self, wire_bytes: int) -> int:
        """Whole install ticks for a wire stream (min 1: even a fully
        skipped delta pays the launch latency)."""
        per = max(int(self.bytes_per_tick), 1)
        return max(1, -(-int(wire_bytes) // per))

    @classmethod
    def from_link(cls, link: "LinkModel",
                  bytes_per_tick: int = 1 << 16) -> "InstallCostModel":
        return cls(bytes_per_s=link.dma_bw, latency_s=link.dma_latency_s,
                   bytes_per_tick=bytes_per_tick)


@dataclasses.dataclass(frozen=True)
class StreamLayer:
    name: str
    bytes_int8: int
    flops_per_token: float
    tokens: int

    def compute_s(self, link: LinkModel, replication: int = 1) -> float:
        flops = self.flops_per_token * self.tokens / max(replication, 1)
        return max(flops / link.peak_flops, self.bytes_int8 / link.hbm_bw)


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    kind: str              # 'install' | 'compute'
    layer: int
    t_start: float
    t_end: float
    slots: int
    replication: int = 1


@dataclasses.dataclass
class StreamPlan:
    layers: Sequence[StreamLayer]
    events: List[StreamEvent]
    slot_bytes: int
    n_slots: int
    makespan_s: float
    serial_makespan_s: float     # naive: install → compute → install …

    @property
    def overlap_speedup(self) -> float:
        return self.serial_makespan_s / self.makespan_s

    def installs(self) -> List[StreamEvent]:
        return [e for e in self.events if e.kind == "install"]


def build_stream_plan(
    layers: Sequence[StreamLayer],
    hbm_weight_budget_bytes: int,
    link: LinkModel = LinkModel(),
    slot_bytes: Optional[int] = None,
    replication: bool = True,
    cost_model: Optional[InstallCostModel] = None,
) -> StreamPlan:
    if cost_model is None:
        cost_model = InstallCostModel.from_link(link)
    if slot_bytes is None:
        slot_bytes = max(l.bytes_int8 for l in layers)
        slot_bytes = max(slot_bytes // 4, 1)  # 4 sub-slots of the biggest layer
    n_slots = max(hbm_weight_budget_bytes // slot_bytes, 1)

    def slots_of(l: StreamLayer) -> int:
        return max(math.ceil(l.bytes_int8 / slot_bytes), 1)

    if max(slots_of(l) for l in layers) > n_slots:
        raise ValueError("arena too small for the largest layer; "
                         "increase budget or shard the layer")

    secs = 1e6  # plan in microseconds to keep numbers O(1)
    costs = [
        LayerCost(
            base_rows=slots_of(l),
            compute_cycles=l.compute_s(link) * secs,
            max_replication=8 if replication else 1,
            write_dma_cycles=cost_model.install_s(l.bytes_int8) * secs,
        )
        for l in layers
    ]

    def wl(idx: int) -> float:
        if idx >= len(layers):
            return float("inf")
        return costs[idx].write_dma_cycles

    events: List[StreamEvent] = []
    free = n_slots
    dma_free = 0.0
    ready = {}
    slots_held = {}
    repl = {}
    w = 0
    t = 0.0

    def issue(now: float) -> None:
        nonlocal w, free, dma_free
        while w < len(layers) and free > 0:
            items = plan_writes(free, w, costs, wl, replication_enabled=replication)
            if not items:
                return
            progressed = False
            for it in items:
                if it.fraction < 1.0:
                    return  # partial installs not supported: slot granularity
                l = layers[it.layer_idx]
                start = max(now, dma_free)
                dur = cost_model.install_s(l.bytes_int8, it.replication)
                end = start + dur
                dma_free = end
                free -= it.rows
                ready[it.layer_idx] = end
                slots_held[it.layer_idx] = it.rows
                repl[it.layer_idx] = it.replication
                events.append(StreamEvent("install", it.layer_idx, start, end,
                                          it.rows, it.replication))
                w = it.layer_idx + 1
                progressed = True
            if not progressed:
                return

    issue(0.0)
    for i, l in enumerate(layers):
        if i not in ready:
            issue(t)
        if i not in ready:
            raise RuntimeError(f"streaming deadlock at layer {i}")
        start = max(t, ready[i])
        dur = l.compute_s(link, repl.get(i, 1))
        end = start + dur
        events.append(StreamEvent("compute", i, start, end, slots_held[i],
                                  repl.get(i, 1)))
        free += slots_held[i]
        t = end
        issue(t)

    makespan = t
    # Naive (Fig 7) reference: strictly serial install → compute.
    serial = 0.0
    for l in layers:
        serial += cost_model.install_s(l.bytes_int8)
        serial += l.compute_s(link)
    return StreamPlan(layers, events, slot_bytes, n_slots, makespan, serial)
