"""Basic layers: RMSNorm, embeddings, rotary, gated MLP — PyTorch port of
`repro.nn.layers`.

Cast points follow the reference exactly: RMSNorm and RoPE run in f32 and
cast back to the activation dtype; the embedding gathers bf16 rows; every
matrix product runs in the activation dtype (the reference casts each
weight to it first, so storing matrices in bf16 changes no value).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.nn.config import ModelConfig

Params = Dict[str, Any]
# a spec tree: the param tree with, in place of each leaf, a tuple of
# logical axes per dim (see `repro_torch.parallel.sharding`)
Specs = Dict[str, Any]


# ---------------------------------------------------------------- RMSNorm
def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * params["scale"].float()).to(dt)


# ---------------------------------------------------------------- Embedding
def rmsnorm_specs() -> Specs:
    return {"scale": (None,)}


def embedding_specs(cfg: ModelConfig) -> Specs:
    s = {"table": ("tp", "fsdp")}
    if not cfg.tie_embeddings:
        s["head"] = ("fsdp", "tp")
    return s


def mlp_specs(gated: bool) -> Specs:
    s = {"w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp")}
    if gated:
        s["w_gate"] = ("fsdp", "tp")
    return s


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["table"].to(torch.bfloat16)[tokens]


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, T, d) -> logits (B, T, vocab_padded) in the activation dtype."""
    head = params.get("head")
    table = head if head is not None else params["table"].t()
    return torch.matmul(x, table.to(torch.bfloat16))


# ---------------------------------------------------------------- Rotary
def rope_angles(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin of shape (..., dim//2), in f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (float(theta) ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., seq, heads, dim); cos/sin: (..., seq, dim//2)."""
    dt = x.dtype
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------- Gated MLP
_SQRT_2_OVER_PI = float(np.sqrt(2 / np.pi))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default (tanh) form, evaluated op by op in x's dtype
    as XLA evaluates it — every intermediate rounded to bf16.  The fused
    `F.gelu(x, approximate="tanh")` rounds once and differs in the last
    bit on a few percent of bf16 outputs, enough to flip greedy picks
    between near-tied logits."""
    # constants rounded to x's dtype first, as jax's weak typing does (a
    # python float times a bf16 tensor computes with the f32 constant);
    # rounded on the host, so the device never waits for a copy
    c, a = torch.tensor([_SQRT_2_OVER_PI, 0.044715]).to(x.dtype).tolist()
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x))))
    return x * cdf


def _silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu, `x * (1 / (1 + exp(-x)))`, evaluated op by op in x's
    dtype as XLA evaluates it; the fused `F.silu` rounds once and differs
    in the last bit on about a third of bf16 outputs."""
    return x * (1 / (1 + torch.exp(-x)))


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return _gelu_tanh(x)
    return _silu(x)


def mlp(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """x: (..., d) -> (..., d); GeGLU/SwiGLU when `w_gate` is present."""
    h = torch.matmul(x, params["w_up"].to(x.dtype))
    if "w_gate" in params:
        g = torch.matmul(x, params["w_gate"].to(x.dtype))
        h = _act(g, act) * h
    else:
        h = _act(h, act)
    return torch.matmul(h, params["w_down"].to(x.dtype))
