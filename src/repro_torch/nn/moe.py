"""Mixture-of-Experts — PyTorch port of `repro.nn.moe` without a mesh.

The reference runs, without an installed mesh, its dense single-device
oracle `moe_reference`: route every token in f32 (softmax, top-k, the k
gates normalized by their sum), evaluate every expert on every token in
bf16, accumulate the gated expert outputs (kept in f32, see `_down_f32`)
in f32 in expert order, cast the sum once to bf16 and add the shared
experts' gated MLP.  It is exact: no
capacity, no dropped token.  That is the function ported here; the mesh
bodies (capacity dispatch, all-to-all, replicated-token decode) wait for
the port's `parallel/`.

`moe_reference` keeps the reference's loop over the experts.  `moe`, what
the blocks call, computes the same function with the experts stacked: one
batched product per weight over every expert, in token chunks that bound
the (E, tokens, d) activations, and the expert-order f32 sum as a
`cumsum` over the expert axis (a sequential scan on either device, so the
sum associates as the reference's loop does).  No host sync and no shape
that depends on the routing, so a decode step stays one fixed sequence of
launches.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import _act, mlp

Params = Dict[str, Any]

# f32 bytes of one (experts, tokens, d) chunk of `moe`'s gated outputs
CHUNK_BYTES = 256 << 20


def init_moe(cfg: ModelConfig, normal) -> Params:
    """The reference's `init_moe` tree and scales (`normal(shape, scale,
    dtype=bf16)` draws one leaf): the router is used in f32, so it is
    drawn in f32; the expert stacks' fan-in is their axis 1 (d for
    gate/up, d_ff_expert for down), not the expert count."""
    d, fe, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {"router": normal((d, e), 1.0 / math.sqrt(d), torch.float32),
         "w_gate": normal((e, d, fe), 1.0 / math.sqrt(d)),
         "w_up": normal((e, d, fe), 1.0 / math.sqrt(d)),
         "w_down": normal((e, fe, d), 1.0 / math.sqrt(fe))}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        p["shared"] = {"w_up": normal((d, fs), 1.0 / math.sqrt(d)),
                       "w_down": normal((fs, d), 1.0 / math.sqrt(fs)),
                       "w_gate": normal((d, fs), 1.0 / math.sqrt(d))}
    return p


def _route(x_f32: torch.Tensor, router: torch.Tensor, topk: int):
    """x (T, D) -> probs (T, E), top-k (T, k) gates (normalized by their
    sum) and expert indices, gates in descending order as `lax.top_k`
    returns them."""
    probs = torch.softmax(x_f32 @ router, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, topk, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def _aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch/GShard load-balance loss: E · Σ_e f_e · p̄_e, f_e the share
    of tokens whose first pick is e."""
    assign = torch.nn.functional.one_hot(gate_idx[..., 0].long(),
                                         n_experts).float()
    return n_experts * torch.sum(assign.mean(0) * probs.mean(0))


def _down_f32(h: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """An expert's down projection, in f32.  The reference casts the bf16
    product to f32 at once, and XLA CPU drops that round trip (excess
    precision): the f32 sum is kept unrounded.  So on the CPU the product
    runs in f32 on the bf16 values; on the card the bf16 GEMM accumulates
    in f32 and rounds its output once, which reads the weights at their
    own width."""
    if h.is_cuda:
        return torch.matmul(h, w_down).float()
    return torch.matmul(h.float(), w_down.float())


def _expert_ffn(w_gate, w_up, w_down, x, act: str) -> torch.Tensor:
    """Per-expert gated FFN.  x: (E, C, D) or (C, D) shared by every
    expert; weights (E, D, F) / (E, F, D) -> (E, C, D) in f32."""
    h = _act(torch.matmul(x, w_gate), act) * torch.matmul(x, w_up)
    return _down_f32(h, w_down)


def _gates(gate_vals, gate_idx, n_experts: int) -> torch.Tensor:
    """(T, E) f32: each token's gate on each expert, 0 where not picked
    (the reference's `(gate_vals * (gate_idx == e)).sum(-1)`: the picks
    are distinct, so each sum holds one gate and zeros)."""
    return torch.zeros(gate_vals.shape[0], n_experts, dtype=gate_vals.dtype,
                       device=gate_vals.device).scatter_(1, gate_idx,
                                                         gate_vals)


def _finish(params: Params, out: torch.Tensor, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    y = out.to(x.dtype).reshape(x.shape)
    if "shared" in params:
        y = y + mlp(params["shared"], x, cfg.act)
    return y


def moe_reference(params: Params, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense single-device MoE, the reference's loop over the experts
    (exact, no capacity drops).  x (B, S, D) -> (y (B, S, D), aux)."""
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    probs, gate_vals, gate_idx = _route(xf.float(), params["router"].float(),
                                        cfg.moe_topk)
    gates = _gates(gate_vals, gate_idx, cfg.n_experts)
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        h = _act(xf @ params["w_gate"][e].to(x.dtype), cfg.act) * (
            xf @ params["w_up"][e].to(x.dtype))
        y = _down_f32(h, params["w_down"][e].to(x.dtype))
        out = out + gates[:, e:e + 1] * y
    aux = _aux_loss(probs, gate_idx, cfg.n_experts)
    return _finish(params, out, x, cfg), aux


def moe(params: Params, x: torch.Tensor, cfg: ModelConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe_reference`'s function with the experts stacked (see the module
    docstring).  x (B, S, D) -> (y (B, S, D), aux)."""
    D = x.shape[-1]
    E = cfg.n_experts
    xf = x.reshape(-1, D)
    probs, gate_vals, gate_idx = _route(xf.float(), params["router"].float(),
                                        cfg.moe_topk)
    gates = _gates(gate_vals, gate_idx, E)
    w_gate, w_up, w_down = (params[k].to(x.dtype)
                            for k in ("w_gate", "w_up", "w_down"))
    out = torch.empty(xf.shape, dtype=torch.float32, device=x.device)
    chunk = max(1, CHUNK_BYTES // (4 * E * max(D, cfg.d_ff_expert)))
    for s in range(0, xf.shape[0], chunk):
        xc = xf[s:s + chunk]
        y = _expert_ffn(w_gate, w_up, w_down, xc, cfg.act)     # (E, C, D)
        contrib = gates[s:s + chunk].t()[:, :, None] * y
        # the expert-order sum: the last prefix of a sequential scan
        out[s:s + chunk] = torch.cumsum(contrib, dim=0)[-1]
    aux = _aux_loss(probs, gate_idx, E)
    return _finish(params, out, x, cfg), aux
