"""ARAS core of the port: the paper's primary contribution (the
counterparts of `repro.core`).

- `layer_graph`     — DNN layer IR (Fig 6's Data Flow Graph)
- `resources`       — PE/APU/crossbar pool accounting (Table II)
- `scheduler`       — offline scheduler producing the static instruction
                      stream (Fig 6/8/9); decisions reused by the streaming
                      executor in `repro_torch.streaming`
- `replication`     — Adaptive Weight Replication, Algorithm 1 (§V-B)
- `bank_selection`  — Adaptive Bank Selection ILP (§V-A)
- `weight_reuse`    — Adaptive Partial Weight Reuse (§V-C)

`scheduler` imports `repro_torch.sim.aras`, which imports this package's
modules: the names below are imported in the reference's order, and
`repro_torch.sim` imports this package before its own modules, so either
package may be imported first.
"""
from repro_torch.core.layer_graph import LayerGraph, LayerNode, conv, fc
from repro_torch.core.resources import AcceleratorConfig, RowPool
from repro_torch.core.scheduler import Schedule, build_schedule, validate_schedule
from repro_torch.core.replication import LayerCost, WriteItem, plan_writes
from repro_torch.core.bank_selection import Bank, BankSelection, make_banks, select_banks
from repro_torch.core.weight_reuse import (
    CENTERS,
    LayerEncoding,
    encode_network,
    cell_hist,
    expected_pulses_per_weight,
    expected_skip_per_cell,
)

__all__ = [
    "LayerGraph", "LayerNode", "conv", "fc",
    "AcceleratorConfig", "RowPool",
    "Schedule", "build_schedule", "validate_schedule",
    "LayerCost", "WriteItem", "plan_writes",
    "Bank", "BankSelection", "make_banks", "select_banks",
    "CENTERS", "LayerEncoding", "encode_network", "cell_hist",
    "expected_pulses_per_weight", "expected_skip_per_cell",
]
