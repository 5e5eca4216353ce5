"""TPU-like systolic-array baseline (paper §VI, Table I; ScaleSim-style).

64×64 INT8 MAC array @ 1 GHz, 4.5 MB unified data buffer, weight-stationary
dataflow: each K×N weight tile (64×64) is loaded into the array (64 cycles)
and M activation rows are streamed through (M cycles + 64 drain).  DRAM
traffic: weights once; activations refetched once per weight-buffer pass when
a layer's weights exceed half the buffer (double buffering).

The port's copy of `repro.sim.tpu`, with the reference's constants kept as
they are: this is the modeled machine the paper compares ARAS with, not
the device the port runs on, and (unlike `repro_torch.streaming.plan`'s
link model) it is not retargeted to the H100.  Its makespans and energies
are model outputs of that machine, never measurements.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core.layer_graph import LayerGraph
from repro_torch.sim.energy import EnergyModel


@dataclasses.dataclass(frozen=True)
class TpuConfig:
    array_rows: int = 64
    array_cols: int = 64
    freq_hz: float = 1e9
    buffer_bytes: int = int(4.5 * 1024 * 1024)
    energy: EnergyModel = EnergyModel()


@dataclasses.dataclass
class TpuResult:
    name: str
    makespan_s: float
    energy: Dict[str, float]

    @property
    def total_energy_j(self) -> float:
        return self.energy["total"]


def simulate_tpu(graph: LayerGraph, config: TpuConfig = TpuConfig(),
                 dram_bw_bytes_per_s: float = 19.2e9 * 0.65) -> TpuResult:
    em = config.energy
    cycles = 0.0
    macs_total = 0.0
    dram_bytes = 0.0
    sram_bytes = 0.0
    for layer in graph.layers:
        m, k, nn = layer.windows, layer.kernel_volume, layer.num_kernels
        k_tiles = math.ceil(k / config.array_rows)
        n_tiles = math.ceil(nn / config.array_cols)
        # Weight-stationary: per tile, load (rows) + stream (M) + drain (cols).
        compute_cycles = k_tiles * n_tiles * (m + config.array_rows + config.array_cols)
        weight_bytes = k * nn  # INT8
        act_bytes = m * k
        out_bytes = m * nn
        # Activation refetch once per weight-buffer pass (double buffered).
        passes = max(1, math.ceil(weight_bytes / (config.buffer_bytes / 2)))
        layer_dram = weight_bytes + act_bytes * passes + out_bytes
        dram_cycles = layer_dram / (dram_bw_bytes_per_s / config.freq_hz)
        cycles += max(compute_cycles, dram_cycles)  # double-buffered overlap
        macs_total += layer.macs
        dram_bytes += layer_dram
        # On-chip traffic: weights into the array once per tile pass,
        # activations read per K-tile, outputs written once per N pass.
        sram_bytes += weight_bytes + act_bytes * n_tiles + out_bytes * k_tiles

    makespan_s = cycles / config.freq_hz
    energy = {
        "compute": macs_total * em.tpu_mac_j,
        "sram": sram_bytes * em.tpu_sram_j_per_byte,
        "dram": dram_bytes * em.dram_j_per_byte,
        "static": em.tpu_leak_w * makespan_s,
    }
    energy["total"] = sum(energy.values())
    return TpuResult(name=graph.name, makespan_s=makespan_s, energy=energy)
