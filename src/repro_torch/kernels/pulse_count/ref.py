"""Plain PyTorch version of pulse_count — the math of
`repro.kernels.pulse_count.ref.pulse_count_ref` through the port's
`xbar.cells.cell_deltas`.  CPU tensors take it; `chip_smoke.py` holds the
kernel against it on the card."""
from typing import Tuple

import torch

from repro_torch.xbar.cells import cell_deltas


def pulse_count_plain(old: torch.Tensor, new: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ|Δ level| over the four 2-bit cells, count of unchanged cells) of
    overwriting uint8 `old` with `new`, as int64 0-dim tensors."""
    d = cell_deltas(old, new)
    return torch.abs(d).sum(dtype=torch.int64), \
        (d == 0).sum(dtype=torch.int64)
