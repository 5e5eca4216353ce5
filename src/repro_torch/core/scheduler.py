"""ARAS offline scheduler (paper §IV, Fig 6/9).

The scheduler statically fixes resource allocation, replication factors,
bank sets and the interleaving of write/compute tasks — DNN inference is
deterministic, so all decisions are made offline and reused across
inferences.  The decision logic lives in `repro_torch.core.replication`,
`repro_torch.core.bank_selection` and `repro_torch.core.weight_reuse`; the
timing engine is the event-driven simulator (`repro_torch.sim.aras`), run
once with instruction recording to produce the static instruction stream
(Fig 6's output).

The port's copy of `repro.core.scheduler`: the layer codes are torch
tensors on any device (see `repro_torch.sim.aras`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.bank_selection import BankSelection, make_banks, select_banks
from repro_torch.core.layer_graph import LayerGraph
from repro_torch.core.weight_reuse import LayerEncoding, encode_network
from repro_torch.sim.aras import (
    ArasSimConfig,
    HETERO_BANKS_BYTES,
    Instruction,
    SimResult,
    simulate_aras,
)


@dataclasses.dataclass
class Schedule:
    """Output of the offline flow (Fig 6): the static execution plan."""

    graph: LayerGraph
    instructions: List[Instruction]
    encodings: List[LayerEncoding]
    reuse_center: Optional[int]
    bank_plan: Dict[int, BankSelection]
    predicted: SimResult

    @property
    def makespan_s(self) -> float:
        return self.predicted.makespan_s

    def writes(self) -> List[Instruction]:
        return [i for i in self.instructions if i.kind == "write"]

    def computes(self) -> List[Instruction]:
        return [i for i in self.instructions if i.kind == "compute"]


def build_schedule(
    graph: LayerGraph,
    layer_codes: Sequence[Tuple[str, torch.Tensor]],
    config: ArasSimConfig = ArasSimConfig.variant("BRW"),
) -> Schedule:
    config = dataclasses.replace(config, record_instructions=True)
    result = simulate_aras(graph, layer_codes, config)
    encodings, center = encode_network(layer_codes, enabled=config.weight_reuse)
    banks = make_banks(
        HETERO_BANKS_BYTES if config.hetero_banks else (256 * 1024,) * 15,
        config.energy.sram_leak_w_per_kb,
        config.energy.sram_bank_overhead_w,
    )
    bank_plan = {
        li: select_banks(banks, l.in_act_bytes, l.out_act_bytes)
        for li, l in enumerate(graph.layers)
    }
    return Schedule(
        graph=graph,
        instructions=result.instructions,
        encodings=encodings,
        reuse_center=center,
        bank_plan=bank_plan,
        predicted=result,
    )


def validate_schedule(schedule: Schedule) -> List[str]:
    """Structural invariants of a legal ARAS schedule (used by tests and as a
    launch-time safety check):

    1. computes are in layer order and non-overlapping (layer-by-layer, §IV);
    2. every segment's weights are fully written before its compute starts;
    3. at no time do allocated rows exceed the pool.
    """
    errors: List[str] = []
    computes = schedule.computes()
    for a, b in zip(computes[:-1], computes[1:]):
        if b.t_start_cycles < a.t_end_cycles - 1e-6:
            errors.append(f"compute overlap: {a.segment} vs {b.segment}")
    write_end: Dict[str, float] = {}
    write_frac: Dict[str, float] = {}
    for w in schedule.writes():
        write_end[w.segment] = max(write_end.get(w.segment, 0.0), w.t_end_cycles)
        write_frac[w.segment] = write_frac.get(w.segment, 0.0) + w.fraction
    for c in computes:
        if c.segment not in write_end:
            errors.append(f"{c.segment} computed but never written")
            continue
        if write_frac[c.segment] < 1.0 - 1e-6:
            errors.append(f"{c.segment} only {write_frac[c.segment]:.2%} written")
        if write_end[c.segment] > c.t_start_cycles + 1e-6:
            errors.append(
                f"{c.segment} compute starts at {c.t_start_cycles:.0f} before "
                f"write completes at {write_end[c.segment]:.0f}"
            )
    return errors
