"""Deterministic, step-indexed synthetic data — port of
`repro.data.pipeline` for the token input mode.

batch(step) is a pure function of (seed, step): numpy's generator seeded
with `SeedSequence([seed, step])` draws the same Zipfian token stream as
the reference, so the port's launchers feed the reference's prompts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.nn.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 1234


def _tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipfian token stream — more LM-like than uniform, still synthetic."""
    z = rng.zipf(1.3, size=shape).astype(np.int64)
    return (z % vocab).astype(np.int32)


def make_batch(cfg: ModelConfig, data: DataConfig,
               step: int) -> Dict[str, np.ndarray]:
    """{"tokens": (global_batch, seq_len) int32} for step `step`."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name}: input_mode "
                                  f"{cfg.input_mode!r} is not ported yet")
    rng = np.random.default_rng(np.random.SeedSequence([data.seed, step]))
    return {"tokens": _tokens(rng, (data.global_batch, data.seq_len),
                              cfg.vocab)}
