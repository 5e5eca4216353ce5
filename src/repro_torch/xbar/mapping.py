"""Mapping DNN layers onto ReRAM crossbars (paper §II-C, Fig 3) — a
copy of `repro.xbar.mapping` (pure Python) for the port.

Each CONV kernel is unrolled into one crossbar *column group*: a kernel of
volume V = R·S·C occupies ceil(V / xbar_rows) vertically-stacked crossbars;
each INT8 weight spans CELLS_PER_WEIGHT adjacent cell columns, so a
``xbar_cols``-wide crossbar holds ``xbar_cols // CELLS_PER_WEIGHT`` kernels
side by side.  FC layers are the V = C_in, K = C_out special case.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.xbar.cells import CELLS_PER_WEIGHT


@dataclasses.dataclass(frozen=True)
class CrossbarSpec:
    rows: int = 128
    cols: int = 128
    cell_bits: int = 2

    @property
    def weights_per_row(self) -> int:
        return self.cols // CELLS_PER_WEIGHT  # 32 for 128 cols / 4 cells

    @property
    def weight_capacity(self) -> int:
        return self.rows * self.weights_per_row  # 4096 INT8 weights


@dataclasses.dataclass(frozen=True)
class LayerMapping:
    """Resource footprint of one layer replica on the crossbar pool."""

    xbars_tall: int      # ceil(kernel_volume / rows): vertical partitions
    xbars_wide: int      # ceil(num_kernels / weights_per_row)
    windows: int         # activation windows to stream (OH*OW, or tokens)
    kernel_volume: int   # weights per kernel (= occupied rows in last xbar)
    num_kernels: int

    @property
    def apus(self) -> int:
        """Crossbars (== APUs; one crossbar per APU) per replica."""
        return self.xbars_tall * self.xbars_wide

    @property
    def weights(self) -> int:
        return self.kernel_volume * self.num_kernels

    def occupied_rows(self, spec: CrossbarSpec) -> int:
        """Total crossbar rows actually written for one replica."""
        full, rem = divmod(self.kernel_volume, spec.rows)
        rows = full * spec.rows + rem  # == kernel_volume
        return rows * self.xbars_wide


def map_layer(
    kernel_volume: int,
    num_kernels: int,
    windows: int,
    spec: CrossbarSpec = CrossbarSpec(),
) -> LayerMapping:
    if kernel_volume <= 0 or num_kernels <= 0:
        raise ValueError("layer must have positive kernel volume and count")
    return LayerMapping(
        xbars_tall=math.ceil(kernel_volume / spec.rows),
        xbars_wide=math.ceil(num_kernels / spec.weights_per_row),
        windows=max(windows, 1),
        kernel_volume=kernel_volume,
        num_kernels=num_kernels,
    )
