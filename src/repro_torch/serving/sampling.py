"""Token sampling for the serving engine — PyTorch port of
`repro.serving.sampling`: greedy by default, temperature / top-k with a
seeded per-request PRNG key otherwise.

Determinism contract: a request's n-th generated token depends only on
(logits, seed, n) — the key is `fold_in(PRNGKey(seed or rid), n)` — so
identical requests through any engine schedule sample identical tokens.

The random stream is jax's, bit for bit: `prng_key`, `fold_in` and
`random_bits` reproduce `jax.random.PRNGKey`, `jax.random.fold_in` and the
32-bit draws of the threefry2x32 PRNG in its partitionable mode (jax's
default: `jax_threefry_partitionable=True`), and `uniform_tiny` the
`uniform(minval=finfo(f32).tiny, maxval=1)` that `jax.random.categorical`
feeds into its Gumbel-argmax.  The uint32 words are carried in int64
tensors and masked to 32 bits after every add and shift.  Only the final
`log`s may differ from XLA's in the last ulp, so sampled tokens, not
Gumbel floats, are what equal the reference's.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under key (k1, k2): uint32 values in int64 tensors (or ints),
    broadcast against each other.  `jax._src.prng._threefry2x32_lowering`."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` with jax's default 32-bit integers: the
    seed becomes an int32, so the key is (0, seed mod 2**32)."""
    return np.array([0, int(seed) & _M32], np.uint32)


def request_key(seed: Optional[int], rid: int) -> np.ndarray:
    """Per-request PRNG root: the explicit seed, else the rid (stable
    across re-admissions — the rid never changes).  A (2,) uint32 key."""
    return prng_key(rid if seed is None else seed)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """`jax.random.fold_in` row by row: keys (..., 2) and data (...) as
    int64 tensors -> the (..., 2) folded keys (the hash of the counter
    pair (0, data))."""
    a, b = threefry2x32(keys[..., 0], keys[..., 1],
                        torch.zeros_like(data), data & _M32)
    return torch.stack([a, b], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element for each key of keys (..., 2): the
    partitionable threefry stream of a (n,) draw, hashing the counters
    (0, i) for i < n and xoring the two output words.  (..., n) int64."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[..., 0:1], keys[..., 1:2],
                        torch.zeros_like(counts), counts)
    return a ^ b


def uniform_tiny(bits: torch.Tensor) -> torch.Tensor:
    """`jax.random.uniform(minval=finfo(f32).tiny, maxval=1)` from 32
    random bits: the top 23 bits as the mantissa of a float in [1, 2),
    minus 1, shifted off zero by tiny.  Exactly jax's f32 values."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    return torch.clamp_min(floats + _F32_TINY, _F32_TINY)


def _categorical(keys: torch.Tensor, steps: torch.Tensor,
                 scaled: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(fold_in(key, step), row)` for each row of
    scaled (R, V) f32: Gumbel noise -log(-log(u)) added to the row, then
    the first argmax."""
    bits = random_bits(fold_in(keys, steps), scaled.shape[-1])
    gumbel = -torch.log(-torch.log(uniform_tiny(bits)))
    return torch.argmax(gumbel + scaled, dim=-1)


def _sample_rows(logits: torch.Tensor, temperatures: torch.Tensor,
                 top_ks: torch.Tensor, keys: torch.Tensor,
                 steps: torch.Tensor) -> torch.Tensor:
    """Draw one token per row of logits (R, vocab) at temperatures (R,)
    > 0, restricted to the top_k largest scaled logits (0 or >= vocab:
    unrestricted) by the reference's k-th-value cut."""
    vocab = logits.shape[-1]
    # division by a tensor: a true division, as jnp's (CUDA turns division
    # by a python scalar into a product with its reciprocal)
    scaled = logits.float() / temperatures[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, 1,
                       torch.clamp(top_ks - 1, 0, vocab - 1)[:, None])
    use_topk = ((top_ks > 0) & (top_ks < vocab))[:, None]
    scaled = torch.where(use_topk & (scaled < kth),
                         torch.full_like(scaled, -float("inf")), scaled)
    return _categorical(keys, steps, scaled)


def sample_token(logits: torch.Tensor, vocab: int, *,
                 temperature: float = 0.0, top_k: int = 0,
                 key: Optional[np.ndarray] = None, step: int = 0) -> int:
    """One token from a single row of next-token logits (>= vocab wide;
    padded tail ignored).  temperature <= 0 is greedy argmax; otherwise a
    draw from `fold_in(key, step)` as `jax.random.categorical` makes it."""
    logits = logits[:vocab]
    if temperature <= 0.0:
        return int(torch.argmax(logits))
    if key is None:
        raise ValueError("temperature sampling needs a PRNG key")
    dev = logits.device
    tok = _sample_rows(
        logits[None],
        torch.tensor([temperature], dtype=torch.float32, device=dev),
        torch.tensor([top_k], dtype=torch.int64, device=dev),
        torch.as_tensor(np.asarray(key, np.int64).reshape(1, 2), device=dev),
        torch.tensor([step], dtype=torch.int64, device=dev))
    return int(tok[0])


def sample_tokens(logits: torch.Tensor, vocab: int, *,
                  temperatures: Sequence[float], top_ks: Sequence[int],
                  keys: Sequence, steps: Sequence[int]) -> torch.Tensor:
    """Batched `sample_token`: (B, V>=vocab) logits -> (B,) int32 tokens on
    the logits' device, row-for-row identical to per-row `sample_token`.

    The per-row controls are host arrays (the engine builds them on the
    host anyway): temperatures (B,) (<= 0 → greedy), top_ks (B,) (0 or
    >= vocab → disabled), keys (B, 2) per-request uint32 roots, steps (B,)
    tokens already generated.  Greedy rows take one batched argmax; the
    sampled rows draw together in one pass.  Nothing here syncs with the
    device."""
    logits = logits[:, :vocab]
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    temperatures = np.asarray(temperatures, np.float32)
    rows = np.nonzero(temperatures > 0.0)[0]
    if rows.size:
        dev = logits.device
        pick = lambda a, dt: torch.as_tensor(  # noqa: E731
            np.asarray(a)[rows].astype(dt), device=dev)
        keys = np.asarray(keys, np.int64).reshape(-1, 2)
        drawn = _sample_rows(
            logits[torch.as_tensor(rows, device=dev)],
            pick(temperatures, np.float32), pick(top_ks, np.int64),
            pick(keys, np.int64), pick(steps, np.int64))
        out[torch.as_tensor(rows, device=dev)] = drawn.to(torch.int32)
    return out
