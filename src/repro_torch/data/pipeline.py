"""Deterministic, step-indexed synthetic data — port of
`repro.data.pipeline`.

batch(step) is a pure function of (seed, step): numpy's generator seeded
with `SeedSequence([seed, step])` makes the same draws in the same order
as the reference (the Zipfian token stream; an encoder's frame
embeddings, targets and loss mask; a VLM's patch embeddings), so the
port's launchers feed the reference's batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

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
    """Step `step`'s batch of global_batch x seq_len, by input mode:
    {"tokens" int32}; {"embeds" f32 (B, S, d_model), "targets" int32,
    "loss_mask" f32} for an embeddings model (half the positions counted,
    masked prediction); {"tokens", "patch_embeds" f32 (B, prefix_len,
    d_model)} for a prefix VLM."""
    rng = np.random.default_rng(np.random.SeedSequence([data.seed, step]))
    B, S = data.global_batch, data.seq_len
    if cfg.input_mode == "embeddings":
        embeds = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
        targets = _tokens(rng, (B, S), cfg.vocab)
        mask = (rng.random((B, S)) < 0.5).astype(np.float32)
        return {"embeds": embeds, "targets": targets, "loss_mask": mask}
    if cfg.input_mode == "prefix_vlm":
        return {
            "tokens": _tokens(rng, (B, S), cfg.vocab),
            "patch_embeds": rng.standard_normal(
                (B, cfg.prefix_len, cfg.d_model), dtype=np.float32),
        }
    return {"tokens": _tokens(rng, (B, S), cfg.vocab)}


def make_batch_specs(cfg: ModelConfig, data: DataConfig
                     ) -> Dict[str, torch.Tensor]:
    """`make_batch`'s leaves as `meta` tensors: shapes and dtypes, no
    allocation (the reference's ShapeDtypeStructs for the dry run)."""
    B, S = data.global_batch, data.seq_len

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    f32, i32 = torch.float32, torch.int32
    if cfg.input_mode == "embeddings":
        return {"embeds": spec((B, S, cfg.d_model), f32),
                "targets": spec((B, S), i32),
                "loss_mask": spec((B, S), f32)}
    if cfg.input_mode == "prefix_vlm":
        return {"tokens": spec((B, S), i32),
                "patch_embeds": spec((B, cfg.prefix_len, cfg.d_model), f32)}
    return {"tokens": spec((B, S), i32)}
