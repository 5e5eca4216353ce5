"""Architecture registry of the port.

Each module exposes ``full()`` (the exact published config) and ``smoke()``
(a reduced same-family config for CPU tests), as in the JAX package.  The
registry holds the families the port serves so far: the dense GQA
decoders (gemma-7b, minicpm-2b, yi-34b, qwen3-32b) and the MoE ones
(deepseek-v2-lite-16b with MLA, qwen3-moe-235b-a22b with GQA).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs import (
    deepseek_v2_lite_16b,
    gemma_7b,
    minicpm_2b,
    qwen3_32b,
    qwen3_moe_235b_a22b,
    yi_34b,
)
from repro_torch.nn.config import ModelConfig

_MODULES = {
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "minicpm-2b": minicpm_2b,
    "qwen3-32b": qwen3_32b,
    "yi-34b": yi_34b,
    "gemma-7b": gemma_7b,
}

ARCHS: Tuple[str, ...] = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[name]
    return mod.smoke() if smoke else mod.full()
