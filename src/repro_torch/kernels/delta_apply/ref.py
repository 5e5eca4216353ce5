"""Plain PyTorch version of delta_apply: `(old + delta) mod 256` in widened
integers — the math of `repro.kernels.delta_apply.ref.delta_apply_ref`.
CPU tensors take it; `chip_smoke.py` holds the kernel against it on the
card."""
import torch


def delta_apply_plain(old: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """uint8 old, delta of one shape -> uint8 (old + delta) mod 256."""
    return ((old.to(torch.int32) + delta.to(torch.int32)) & 0xFF).to(torch.uint8)
