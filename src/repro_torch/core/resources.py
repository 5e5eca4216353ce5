"""Accelerator resource accounting (paper Table II) — a copy of
`repro.core.resources` (pure Python) for the port.

The allocation granularity is a *PE row of APUs*: all APUs within a PE row
share the broadcast activations, so a row is exclusively owned by one layer
(§IV-C).  96 PEs × 6 rows × 4 APUs/row = 576 allocatable rows = 2304 APUs.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.xbar.mapping import CrossbarSpec


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """Hardware parameters of ARAS (paper Table II defaults)."""

    num_pes: int = 96
    apu_rows_per_pe: int = 6
    apus_per_row: int = 4
    xbar: CrossbarSpec = CrossbarSpec()
    freq_hz: float = 1e9
    xbar_compute_cycles: int = 96          # per activation window per crossbar
    xbar_write_cycles: int = 768_000       # per crossbar (128 rows × 2 phases)
    dram_bw_bytes_per_s: float = 19.2e9    # LPDDR4, single channel (peak)
    dram_efficiency: float = 0.65          # sustained/peak (DRAMSim3-class)
    num_adcs_per_apu: int = 16
    adc_bits: int = 6
    pe_buffer_bytes: int = 1536            # 1.5 KB
    activation_bits: int = 8

    @property
    def dram_bw_effective(self) -> float:
        return self.dram_bw_bytes_per_s * self.dram_efficiency

    @property
    def total_rows(self) -> int:
        return self.num_pes * self.apu_rows_per_pe

    @property
    def total_apus(self) -> int:
        return self.total_rows * self.apus_per_row

    @property
    def weight_capacity(self) -> int:
        """INT8 weights the whole pool can hold at once."""
        return self.total_apus * self.xbar.weight_capacity

    def rows_for_apus(self, apus: int) -> int:
        return math.ceil(apus / self.apus_per_row)

    def cycles_to_seconds(self, cycles: float) -> float:
        return cycles / self.freq_hz


class RowPool:
    """Free-list of PE rows.  Fragmentation-free by construction: rows are
    fungible (the NoC routes any layer's activations to any PE)."""

    def __init__(self, config: AcceleratorConfig):
        self.config = config
        self.free_rows = config.total_rows

    def can_allocate(self, rows: int) -> bool:
        return rows <= self.free_rows

    def allocate(self, rows: int) -> None:
        if rows > self.free_rows:
            raise RuntimeError(
                f"allocating {rows} rows but only {self.free_rows} free"
            )
        self.free_rows -= rows

    def release(self, rows: int) -> None:
        self.free_rows += rows
        if self.free_rows > self.config.total_rows:
            raise RuntimeError("released more rows than the pool owns")
