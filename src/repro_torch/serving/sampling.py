"""Token sampling for the serving engine — PyTorch port of
`repro.serving.sampling`: greedy by default, temperature / top-k with a
seeded per-request generator otherwise.

Determinism contract: a request's n-th generated token depends only on
(logits, seed, n) — its draw comes from a `torch.Generator` seeded from
(seed or rid, n) on the logits' device — so identical requests through any
engine schedule sample identical tokens.  Greedy is bit-identical to the
reference; sampled tokens follow torch's generator, not jax's threefry
stream, so they differ from the reference's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def request_key(seed: Optional[int], rid: int) -> int:
    """Per-request sampling root: the explicit seed, else the rid (stable
    across re-admissions — the rid never changes)."""
    return rid if seed is None else int(seed)


def _generator(key: int, step: int, device: torch.device) -> torch.Generator:
    seed = np.random.SeedSequence([int(key) & 0xFFFFFFFF, int(step)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))
    return gen


def _draw(row: torch.Tensor, temperature: float, top_k: int, key: int,
          step: int) -> torch.Tensor:
    """Gumbel-argmax draw from softmax(row / temperature), restricted to
    the top_k largest (0 or >= len(row): unrestricted) — the reference's
    kth-value cut.  Returns a 0-dim int64 tensor on row's device."""
    scaled = row.float() / temperature
    if 0 < top_k < row.shape[0]:
        kth = torch.topk(scaled, top_k).values[-1]
        scaled = torch.where(scaled < kth,
                             torch.full_like(scaled, -float("inf")), scaled)
    u = torch.rand(scaled.shape, generator=_generator(key, step, row.device),
                   device=row.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return torch.argmax(scaled + gumbel)


def sample_token(logits: torch.Tensor, vocab: int, *,
                 temperature: float = 0.0, top_k: int = 0,
                 key: Optional[int] = None, step: int = 0) -> int:
    """One token from a single row of next-token logits (>= vocab wide;
    padded tail ignored).  temperature <= 0 is greedy argmax."""
    logits = logits[:vocab]
    if temperature <= 0.0:
        return int(torch.argmax(logits))
    if key is None:
        raise ValueError("temperature sampling needs a key")
    return int(_draw(logits, temperature, top_k, key, step))


def sample_tokens(logits: torch.Tensor, vocab: int, *,
                  temperatures: Sequence[float], top_ks: Sequence[int],
                  keys: Sequence[int], steps: Sequence[int]) -> torch.Tensor:
    """Batched `sample_token`: (B, V>=vocab) logits -> (B,) int32 tokens on
    the logits' device, row-for-row identical to per-row `sample_token`.

    The per-row controls are host arrays (the engine builds them on the
    host anyway): temperatures (B,) (<= 0 → greedy), top_ks (B,) (0 or
    >= vocab → disabled), keys (B,) per-request roots, steps (B,) tokens
    already generated.  Greedy rows take one batched argmax; each sampled
    row draws from its own generator.  Nothing here syncs with the
    device."""
    logits = logits[:, :vocab]
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    temperatures = np.asarray(temperatures, np.float32)
    for r in np.nonzero(temperatures > 0.0)[0]:
        out[r] = _draw(logits[r], float(temperatures[r]), int(top_ks[r]),
                       int(keys[r]), int(steps[r]))
    return out
