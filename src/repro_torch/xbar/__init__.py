"""Crossbar numerics of the port: INT8 quantization, 2-bit ReRAM cell
arithmetic and the mapping of layers onto crossbars (the counterparts of
`repro.xbar`).

This package is the numerical substrate shared by the simulator
(`repro_torch.sim`), the weight-reuse optimization
(`repro_torch.core.weight_reuse`) and the streaming path
(`repro_torch.streaming`).
"""
from repro_torch.xbar.quant import (
    QuantParams,
    quantize,
    dequantize,
    quantize_tensor,
    shift_weights,
    dot_int8,
)
from repro_torch.xbar.cells import (
    CELL_BITS,
    CELLS_PER_WEIGHT,
    LEVELS,
    pack_cells,
    unpack_cells,
    pulse_count,
    skip_ratio,
    cell_similarity,
)
from repro_torch.xbar.mapping import CrossbarSpec, LayerMapping, map_layer

__all__ = [
    "QuantParams", "quantize", "dequantize", "quantize_tensor",
    "shift_weights", "dot_int8",
    "CELL_BITS", "CELLS_PER_WEIGHT", "LEVELS",
    "pack_cells", "unpack_cells", "pulse_count", "skip_ratio",
    "cell_similarity",
    "CrossbarSpec", "LayerMapping", "map_layer",
]
