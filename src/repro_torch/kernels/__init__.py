"""The port's hand-written CUDA kernels, one package each, and what their
wrappers share."""
import torch


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t` when its data starts on a 16-byte boundary, else a copy that
    does: the kernels' 16-byte copies (TMA, `cp.async`) read only from
    such addresses."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
