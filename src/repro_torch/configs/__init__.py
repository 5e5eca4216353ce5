"""Architecture registry of the port.

Each module exposes ``full()`` (the exact published config) and ``smoke()``
(a reduced same-family config for CPU tests), as in the JAX package.  The
registry holds the families the port serves so far: gemma-7b.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs import gemma_7b
from repro_torch.nn.config import ModelConfig

_MODULES = {
    "gemma-7b": gemma_7b,
}

ARCHS: Tuple[str, ...] = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[name]
    return mod.smoke() if smoke else mod.full()
