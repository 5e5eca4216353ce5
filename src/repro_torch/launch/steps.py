"""Serving step functions — PyTorch port of the serving half of
`repro.launch.steps`.

The reference wraps each step in a cached `jax.jit`; PyTorch runs
eagerly, so these are plain functions and no compile cache is needed.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.nn.config import ModelConfig
from repro_torch.nn.model import decode_step, prefill
from repro_torch.serving.sampling import sample_tokens


def prefill_step(params, tokens: torch.Tensor, cfg: ModelConfig,
                 cache_len: int):
    """(`cached_prefill_step`) prompt tokens (B, S) -> (next-token logits
    (B, vocab_padded), batch caches of length cache_len)."""
    return prefill(params, tokens, cfg, cache_len)


def paged_serve_step(params, token, caches, pos, page_table,
                     cfg: ModelConfig):
    """(`cached_paged_serve_step`) one decode step over a paged KV arena:
    caches are page pools (written in place), pos the per-row (B,) write
    positions, page_table (B, T) each row's block -> page map.  Returns
    (logits (B, vocab_padded), caches)."""
    return decode_step(params, token, caches, pos, cfg, page_table)


def fused_paged_serve_step(params, token, caches, pos, page_table,
                           temps: Sequence[float], top_ks: Sequence[int],
                           keys: Sequence, steps: Sequence[int],
                           cfg: ModelConfig):
    """(`cached_fused_paged_serve_step`) paged decode step with sampling
    fused in: the logits stay on the device and only the (B,) int32 token
    ids come back.  Sampler controls as in `sample_tokens`."""
    logits, caches = decode_step(params, token, caches, pos, cfg, page_table)
    toks = sample_tokens(logits, cfg.vocab, temperatures=temps,
                         top_ks=top_ks, keys=keys, steps=steps)
    return toks, caches


def sample_step(logits, vocab: int, temps: Sequence[float],
                top_ks: Sequence[int], keys: Sequence,
                steps: Sequence[int]) -> torch.Tensor:
    """(`cached_sample_tokens`) batched sampler for the split path: one
    call per decode batch, never one host sync per row."""
    return sample_tokens(logits, vocab, temperatures=temps, top_ks=top_ks,
                         keys=keys, steps=steps)
