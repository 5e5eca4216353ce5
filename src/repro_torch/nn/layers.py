"""Basic layers: RMSNorm, embeddings, rotary, gated MLP — PyTorch port of
`repro.nn.layers`.

Cast points follow the reference exactly: RMSNorm and RoPE run in f32 and
cast back to the activation dtype; the embedding gathers bf16 rows; every
matrix product runs in the activation dtype (the reference casts each
weight to it first, so storing matrices in bf16 changes no value).  The
table's gradient sums each row's occurrences in f32 and rounds the row
once (`_Lookup`).

On the split path (`parallel.sharding.split_mesh`: the dense GQA and the
MoE families in training) `embed` and `mlp` take this rank's blocks:
`embed` looks its batch block's tokens up in its rows of the table (vocab
over `model`, the d columns gathered over `data`) and reduce-scatters the
rows over `model` into its sequence block; `mlp` (a dense layer's, and a
MoE layer's shared experts) gathers its sequence block over `model`, runs
its columns of `w_up`/`w_gate` and rows of `w_down` (gathered over
`data`) and reduce-scatters the partial sums back into the sequence block
(`partial_sum`: in f32, rounded once).  `vocab_block` gives the table or
head block the split loss unembeds with.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.nn.config import ModelConfig
from repro_torch.parallel.collectives import all_gather, reduce_scatter
from repro_torch.parallel.sharding import split_mesh

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


class _Lookup(torch.autograd.Function):
    """`table[ids]`; backward, each row's gradients summed in f32 and
    rounded once to the table's dtype.  Indexing's own backward adds each
    occurrence into the bf16 row and rounds each time, so a row stops
    growing once its sum is ~256 times an occurrence's: a Zipfian batch of
    8,192 tokens holds one token 2,057 times, and the tied table's
    gradient then depends on how the batch is blocked."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        acc = grad.new_zeros(ctx.rows, dtype=torch.float32)
        acc.index_put_((ids.reshape(-1).long(),),
                       grad.reshape(-1, ctx.rows[-1]).float(),
                       accumulate=True)
        return acc.to(grad.dtype), None


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    ctx = split_mesh()
    if ctx is None:
        return _Lookup.apply(params["table"].to(torch.bfloat16), tokens)
    # tokens (B_l, S) -> this rank's (B_l, S / model, d) block
    table = all_gather(params["table"].to(torch.bfloat16), ctx, "data", 1)
    rows = table.shape[0]
    local = tokens - ctx.index("model") * rows
    inside = (local >= 0) & (local < rows)
    x = _Lookup.apply(table, torch.where(inside, local,
                                         torch.zeros_like(local)))
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return reduce_scatter(x, ctx, "model", 1)


def vocab_block(params: Params, ctx) -> torch.Tensor:
    """The split path's (d, vocab / model) unembedding block: the head's
    columns or the tied table's rows, gathered over `data`."""
    head = params.get("head")
    if head is not None:
        return all_gather(head.to(torch.bfloat16), ctx, "data", 0)
    return all_gather(params["table"].to(torch.bfloat16), ctx, "data",
                      1).t()


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
    """x: (..., d) -> (..., d); GeGLU/SwiGLU when `w_gate` is present.  On
    the split path x and the result are (B_l, S / model, d) blocks."""
    ctx = split_mesh()
    w = {k: v.to(x.dtype) for k, v in params.items()}
    if ctx is not None:
        x = all_gather(x, ctx, "model", 1)
        w = {k: all_gather(v, ctx, "data", 1 if k == "w_down" else 0)
             for k, v in w.items()}
    h = torch.matmul(x, w["w_up"])
    if "w_gate" in w:
        g = torch.matmul(x, w["w_gate"])
        h = _act(g, act) * h
    else:
        h = _act(h, act)
    if ctx is not None:
        return partial_sum(h, w["w_down"], ctx)
    return torch.matmul(h, w["w_down"])


def partial_sum(h: torch.Tensor, w: torch.Tensor, ctx) -> torch.Tensor:
    """`h @ w` where the contracted dim is split over `model`, this rank's
    sequence block (dim 1) of it, rounded to h's dtype once, as one
    process rounds the whole product once: each rank's partial product in
    f32, reduce-scattered over `model` in f32.  (Rounding each partial to
    bf16 before the sum moves the stream about an ulp, enough to flip a
    MoE router's pick between near-tied experts.)  A one-rank `model`
    holds the whole product: it takes the product in h's dtype, as one
    process does."""
    if ctx.size("model") == 1:
        return reduce_scatter(torch.matmul(h, w), ctx, "model", 1)
    y = torch.matmul(h.float(), w.float())
    return reduce_scatter(y, ctx, "model", 1).to(h.dtype)
