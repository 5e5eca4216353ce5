"""Tenant-variant helper — PyTorch port of `repro.serving.variants`: derive
a "fine-tuned" copy of a model's params (small deltas on the big tensors),
the co-hosted model-variant regime where cross-tenant §V-C delta installs
have real structure to exploit.

The draws are the reference's: one `np.random.default_rng(seed)` walked
over the leaves in `jax.tree.map`'s order (dict keys sorted, lists in
order), one `standard_normal` value per element.  An f32 leaf is perturbed
with the reference's numpy arithmetic, `a + (scale * a.std() *
z).astype(a.dtype)` with `a.std()` in f32 and `z` in float64, so on the
CPU the port's leaves equal the reference's bit for bit.  A leaf of
another dtype (the bf16 matrices of `init_params` and
`params_from_reference`) has no numpy counterpart: its std is taken in
float64 on its own device, and the f32 noise is rounded to its dtype
before the add.  The normals are drawn in chunks, which a sequential
Generator turns into the same stream as one draw: a stacked full-width
leaf would otherwise need its whole size in float64 at once.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

CHUNK = 1 << 24     # normals drawn per call


def _noise(rng: np.random.Generator, n: int, factor) -> np.ndarray:
    """`(factor * z).astype(float32)` for n standard normals z, in
    chunks."""
    out = np.empty(n, np.float32)
    for s in range(0, n, CHUNK):
        z = rng.standard_normal(min(CHUNK, n - s))
        out[s:s + z.size] = (factor * z).astype(np.float32)
    return out


def _std(leaf: torch.Tensor) -> float:
    """Population std of a leaf in float64, chunk by chunk on its device."""
    flat = leaf.reshape(-1)
    total = sum(float(flat[s:s + CHUNK].double().sum())
                for s in range(0, flat.numel(), CHUNK))
    mean = total / flat.numel()
    sq = sum(float((flat[s:s + CHUNK].double() - mean).square().sum())
             for s in range(0, flat.numel(), CHUNK))
    return (sq / flat.numel()) ** 0.5


def _perturb(leaf: torch.Tensor, scale: float, rng: np.random.Generator
             ) -> torch.Tensor:
    if leaf.ndim < 2 or leaf.numel() < 1024:
        return leaf
    if leaf.dtype == torch.float32:
        a = leaf.cpu().numpy()
        noise = _noise(rng, a.size, scale * a.std()).reshape(a.shape)
        return torch.from_numpy(a + noise).to(leaf.device)
    factor = scale * _std(leaf)
    out = torch.empty_like(leaf)
    src, dst = leaf.reshape(-1), out.view(-1)
    for s in range(0, src.numel(), CHUNK):
        n = min(CHUNK, src.numel() - s)
        noise = torch.from_numpy(_noise(rng, n, factor)).to(leaf.device)
        torch.add(src[s:s + n], noise.to(leaf.dtype), out=dst[s:s + n])
    return out


def perturbed_variant(params: Any, scale: float = 0.02, seed: int = 1
                      ) -> Any:
    """A copy of `params` whose leaves of >= 2 dims and >= 1024 elements
    carry N(0, (scale · std)²) noise; smaller leaves are shared."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            done = {k: walk(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if node is None:
            return None
        return _perturb(node, scale, rng)

    return walk(params)
