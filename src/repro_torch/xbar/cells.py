"""2-bit multi-level ReRAM cell arithmetic (paper §II-B, §V-C) — PyTorch
port of `repro.xbar.cells`.

Each INT8 weight code occupies ``CELLS_PER_WEIGHT = 4`` cells of
``CELL_BITS = 2`` bits (levels 0..3).  Cell 0 holds the least-significant
pair, cell 3 the most-significant pair (the paper's "4th cell").

Updating a cell from level a to level b costs ``|a - b|`` programming pulses
(incremental SET/RESET pulse trains); equal levels are *skipped* entirely.
The write latency of a row-phase is set by the slowest cell in the row
(max |Δ| over the row for that polarity).

Integer results are int32 tensors as in the reference (the totals int64,
since torch sums integers in int64); ratios and histograms are float32.
"""
from __future__ import annotations

import torch

CELL_BITS = 2
CELLS_PER_WEIGHT = 8 // CELL_BITS  # = 4
LEVELS = 1 << CELL_BITS            # = 4


def _shifts(device) -> torch.Tensor:
    return torch.arange(CELLS_PER_WEIGHT, dtype=torch.int32,
                        device=device) * CELL_BITS  # [0, 2, 4, 6]


def pack_cells(code: torch.Tensor) -> torch.Tensor:
    """uint8 codes (...,) -> cell levels (..., 4) int32, cell 0 = LSBs."""
    c = code.to(torch.int32)
    return (c[..., None] >> _shifts(c.device)) & (LEVELS - 1)


def unpack_cells(cells: torch.Tensor) -> torch.Tensor:
    """Cell levels (..., 4) -> uint8 codes (...,)."""
    c = cells.to(torch.int32) << _shifts(cells.device)
    return c.sum(dim=-1).to(torch.uint8)


def cell_deltas(old_code: torch.Tensor, new_code: torch.Tensor
                ) -> torch.Tensor:
    """Signed per-cell level deltas (..., 4) when overwriting old with new."""
    return pack_cells(new_code) - pack_cells(old_code)


def pulse_count(old_code: torch.Tensor, new_code: torch.Tensor
                ) -> torch.Tensor:
    """Total programming pulses to overwrite ``old_code`` with ``new_code``.

    This is the paper's "ReRAM writing activity" metric (Fig 13).
    """
    return torch.abs(cell_deltas(old_code, new_code)).sum()


def pulse_count_per_cell(old_code: torch.Tensor, new_code: torch.Tensor
                         ) -> torch.Tensor:
    """Per-cell-index pulse totals, shape (4,) — MSB cells are index 2, 3."""
    d = torch.abs(cell_deltas(old_code, new_code))
    return d.reshape(-1, CELLS_PER_WEIGHT).sum(dim=0)


def skip_ratio(old_code: torch.Tensor, new_code: torch.Tensor
               ) -> torch.Tensor:
    """Fraction of cells whose level is unchanged (skippable writes)."""
    d = cell_deltas(old_code, new_code)
    return (d == 0).to(torch.float32).mean()


def skip_ratio_per_cell(old_code: torch.Tensor, new_code: torch.Tensor
                        ) -> torch.Tensor:
    d = cell_deltas(old_code, new_code)
    return (d == 0).to(torch.float32).reshape(-1, CELLS_PER_WEIGHT).mean(0)


def cell_value_histogram(code: torch.Tensor, cell: int) -> torch.Tensor:
    """P_i(k) of the paper's Eq. 3: distribution of levels in cell ``cell``."""
    levels = pack_cells(code)[..., cell].reshape(-1)
    counts = torch.bincount(levels, minlength=LEVELS).to(torch.float32)
    return counts / levels.shape[0]


def cell_similarity(code_x: torch.Tensor, code_y: torch.Tensor, cell: int
                    ) -> torch.Tensor:
    """Paper Eq. 3: Sim(X, Y, i) = Σ_k P_i_X(k) · P_i_Y(k).

    Probability that cell ``cell`` keeps its value when a random weight of
    layer Y overwrites a random weight of layer X in the same crossbar cell.
    """
    px = cell_value_histogram(code_x, cell)
    py = cell_value_histogram(code_y, cell)
    return (px * py).sum()


def row_phase_pulses(old_code: torch.Tensor, new_code: torch.Tensor
                     ) -> torch.Tensor:
    """Max pulses per polarity for a crossbar *row* of weights.

    ``old_code``/``new_code``: (row_weights,) uint8.  Row write latency is
    2 phases; each phase is bounded by the slowest cell needing that polarity
    (increase phase: max positive Δ; decrease phase: max negative Δ).
    Returns (inc_pulses, dec_pulses).
    """
    d = cell_deltas(old_code, new_code)
    inc = torch.clamp_min(d, 0).max()
    dec = torch.clamp_min(-d, 0).max()
    return torch.stack([inc, dec])
