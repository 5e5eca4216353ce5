"""The port's hand-written CUDA kernels, one package each, and what their
wrappers share.

`counting()` opens a tally of the work the attention wrappers are asked
for, by formula: the dry run (`repro_torch.launch.dryrun`) reads it, since
neither a kernel's `meta` route nor its ctypes launch is an aten op that
`torch.utils.flop_counter` or a dispatch mode could see.  With no tally
open, `tally_work` does nothing.  The tally is one per process, not per
thread: autograd runs a CUDA backward (and a rematerialized forward in it)
on a thread of its own."""
import contextlib
from typing import Dict, Optional

import torch

_TALLY: Optional[Dict[str, float]] = None


@contextlib.contextmanager
def counting():
    """For the body of the `with`: a tally {"flops", "bytes", and each
    kernel's calls by name} that the kernel wrappers add their work to.
    The previous tally, if any, is restored after it."""
    global _TALLY
    prev, _TALLY = _TALLY, {"flops": 0, "bytes": 0}
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def tally_work(name: str, flops: int, n_bytes: int) -> None:
    """Add one call of kernel `name` doing `flops` and moving `n_bytes`
    to the open tally; nothing when none is open."""
    if _TALLY is not None:
        _TALLY["flops"] += flops
        _TALLY["bytes"] += n_bytes
        _TALLY[name] = _TALLY.get(name, 0) + 1


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t` when its data starts on a 16-byte boundary, else a copy that
    does: the kernels' 16-byte copies (TMA, `cp.async`) read only from
    such addresses."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
