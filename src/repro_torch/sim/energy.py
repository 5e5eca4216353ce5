"""Energy model constants (32 nm class, paper §VI methodology analogues) —
a copy of `repro.sim.energy` for the port.

The paper characterizes crossbars with NeuroSim, SRAM with CACTI-P, logic
with Synopsys DC (32 nm) and DRAM with DRAMSim3 — none of which publish the
resulting joule constants in the paper, and none of which are runnable in
this offline container.  The constants below are set to NeuroSim/CACTI-class
values from the public literature and are the declared free parameters of
this reproduction (see DESIGN.md §4): absolute joules are approximate, the
*relative* behaviours (write-dominated NLP, static-heavy CNNs, negligible
compute) are the reproduction targets.

All values are joules / watts at 1 GHz, 32 nm.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    # --- ReRAM crossbar ---
    # One incremental SET/RESET programming pulse on a 2-bit 1T1R cell.
    write_pulse_j: float = 20e-12
    # One crossbar × one activation-window dot-product: 128 SLs × 8 bit-serial
    # iterations sampled by the shared 6-bit ADC pool (~0.4 pJ/conv) plus
    # DAC/WL-driver and S&H overheads.
    xbar_op_j: float = 0.35e-9
    # Leakage of one APU's periphery (ADC pool dominates).
    apu_leak_w: float = 65e-6

    # --- SRAM (CACTI-P class, 32 nm, low-standby-power cells) ---
    sram_leak_w_per_kb: float = 60e-6
    sram_bank_overhead_w: float = 0.2e-3
    sram_access_j_per_byte: float = 1.2e-12

    # --- Logic / rest-of-chip static (controllers, NoC, SFU, ACC) ---
    chip_other_leak_w: float = 0.05

    # --- Main memory (LPDDR4, ~5 pJ/bit incl. PHY) ---
    dram_j_per_byte: float = 25e-12

    # --- TPU-like accelerator (same 32 nm node, area-matched, Table I) ---
    tpu_mac_j: float = 0.55e-12          # INT8 MAC incl. local register movement
    tpu_sram_j_per_byte: float = 2.4e-12  # 4.5 MB unified buffer access
    tpu_leak_w: float = 0.42             # buffers + 64×64 MAC array + logic

    # Expected incremental pulses to program one 2-bit cell whose target
    # level is uniform in {0..3} from an erased (level-0) cell: E|Δ| = 1.5.
    # The KV plane has no per-cell delta tracking (pages are programmed
    # whole), so byte traffic converts to pulses through this expectation.
    kv_pulses_per_cell: float = 1.5

    def aras_static_w(self, num_apus: int, gbuffer_leak_w: float) -> float:
        """Chip static power given the currently-active Gbuffer bank set."""
        return self.chip_other_leak_w + num_apus * self.apu_leak_w + gbuffer_leak_w

    def weight_write_j(self, pulses: float) -> float:
        """Energy of `pulses` incremental SET/RESET programming pulses —
        the serving engine's §V-C install accounting priced in joules."""
        return float(pulses) * self.write_pulse_j

    def kv_write_j(self, n_bytes: float) -> float:
        """Energy to program `n_bytes` of KV-page traffic into 2-bit cells
        (4 cells per byte — `repro_torch.xbar.cells.CELLS_PER_WEIGHT`) at the
        expected erased-cell programming cost per cell."""
        return float(n_bytes) * 4 * self.kv_pulses_per_cell * self.write_pulse_j
