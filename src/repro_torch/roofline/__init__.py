"""Roofline terms and the dry run's table — PyTorch port of
`repro.roofline`, with the H100's peaks."""
from repro_torch.roofline.analysis import (
    HW,
    collective_bytes_from_hlo,
    roofline_terms,
)

__all__ = ["HW", "collective_bytes_from_hlo", "roofline_terms"]
