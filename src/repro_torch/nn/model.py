"""Top-level language model — PyTorch port of `repro.nn.model` for token
LMs: embeddings → stack → norm → logits, plus the serving entry points:
monolithic prefill, chunked prefill into a staging cache, and decode over
contiguous (slot) or paged caches.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import embed, rmsnorm, unembed
from repro_torch.nn.transformer import apply_stack, layer_kind, stack_plan

Params = Dict[str, Any]


# ------------------------------------------------------------------ init
def _block_shapes(cfg: ModelConfig) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Matrix shapes of one dense attention block (fan-in is dim 0)."""
    d = cfg.d_model
    shapes = {
        "attn": {"w_q": (d, cfg.q_dim), "w_k": (d, cfg.kv_dim),
                 "w_v": (d, cfg.kv_dim), "w_o": (cfg.q_dim, d)},
        "mlp": {"w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)},
    }
    if cfg.gated:
        shapes["mlp"]["w_gate"] = (d, cfg.d_ff)
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights with the reference's tree, shapes and scales
    (`repro.nn.model.init_params`): matrices N(0, 1)/sqrt(fan_in), the
    embedding N(0, 1)·0.02, norm scales 1.  Drawn from a `torch.Generator`
    seeded with `seed` on `device` (the draws differ from jax's), matrices
    stored in bf16 and norm scales in f32 (see `repro_torch.weights`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf16 = torch.bfloat16

    def normal(shape, scale):
        out = torch.empty(shape, dtype=bf16, device=dev)
        # one f32 draw per leading slice keeps the f32 scratch small
        for row in out.view(-1, *shape[-2:]) if len(shape) > 2 else [out]:
            row.copy_(torch.randn(row.shape, generator=gen, device=dev)
                      .mul_(scale))
        return out

    for start, _, _ in stack_plan(cfg):
        if layer_kind(cfg, start) != "attn" or cfg.layer_is_moe[start] \
                or cfg.attn_type != "gqa" or cfg.qk_norm:
            raise NotImplementedError(f"{cfg.name}: only dense GQA stacks "
                                      "are ported yet")
    emb = {"table": normal((cfg.vocab_padded, cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        emb["head"] = normal((cfg.d_model, cfg.vocab_padded),
                             1.0 / math.sqrt(cfg.d_model))
    segments: List[Params] = []
    for _, length, scanned in stack_plan(cfg):
        lead = (length,) if scanned else ()
        mats = {part: {name: normal(lead + shape, 1.0 / math.sqrt(shape[0]))
                       for name, shape in shapes.items()}
                for part, shapes in _block_shapes(cfg).items()}
        segments.append({
            "norm1": {"scale": torch.ones(lead + (cfg.d_model,), device=dev)},
            "attn": mats["attn"],
            "norm2": {"scale": torch.ones(lead + (cfg.d_model,), device=dev)},
            "mlp": mats["mlp"]})
    return {"embedding": emb, "stack": {"segments": segments},
            "final_norm": {"scale": torch.ones(cfg.d_model, device=dev)}}


# --------------------------------------------------------------- forward
def _inputs_to_x(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, int]:
    """The model's input stream from a batch dict: (x, prefix_len).  Only
    the token input mode (`batch["tokens"]` (B, S)) is ported."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name}: input_mode "
                                  f"{cfg.input_mode!r} is not ported yet")
    return embed(params["embedding"], batch["tokens"], cfg), 0


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches=None, cache_pos=None, make_cache: bool = False,
            cache_len: int = 0, last_only: bool = False, page_table=None
            ) -> Tuple[torch.Tensor, Optional[Any]]:
    """tokens (B, S) -> (logits (B, S|1, vocab_padded), new_caches).
    ``last_only`` restricts the unembed to the final position."""
    x, _ = _inputs_to_x(params, {"tokens": tokens}, cfg)
    x, new_caches = apply_stack(
        params["stack"], x, cfg, caches=caches, cache_pos=cache_pos,
        make_cache=make_cache, cache_len=cache_len, page_table=page_table)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps).to(torch.bfloat16)
    if last_only:
        x = x[:, -1:]
    return unembed(params["embedding"], x, cfg), new_caches


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            cache_len: int):
    """Run the prompt (B, S) through the model, returning
    (next_token_logits (B, vocab_padded), caches of length cache_len)."""
    logits, caches = forward(params, tokens, cfg, make_cache=True,
                             cache_len=cache_len, last_only=True)
    return logits[:, 0], caches


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, staging: bool = False, device="cuda"):
    """Zeroed contiguous caches mirroring the stack's segment plan:
    scanned segments get stacked (length, ...) leaves, singles get dicts.
    ``staging=True`` gives the chunked-prefill staging layout: windowed
    layers keep full ``cache_len`` buffers (the window is applied in the
    score mask) and int8 tenants keep raw K/V in ``dtype`` (quantized once
    at page install, as the monolithic prefill quantizes after attending).
    Only GQA attention stacks are ported."""
    dev = resolve_device(device)
    int8 = cfg.kv_cache_dtype == "int8" and not staging
    caches = []
    for start, length, scanned in stack_plan(cfg):
        kind = layer_kind(cfg, start)
        if kind != "attn" or cfg.attn_type != "gqa":
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): "
                f"{kind if kind != 'attn' else cfg.attn_type} caches are "
                "not ported yet")
        window = cfg.window_for_layer(start)
        L = min(window, cache_len) if window and not staging else cache_len
        shape = ((length,) if scanned else ()) + (
            batch, L, cfg.n_kv_heads, cfg.head_dim)
        kv_dt = torch.int8 if int8 else dtype
        entry = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
                 "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
        if int8:
            entry["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=dev)
            entry["v_scale"] = torch.zeros_like(entry["k_scale"])
        caches.append({"attn": entry})
    return caches


def chunk_prefill(params: Params, tokens: torch.Tensor, caches, start: int,
                  n_valid: int, cfg: ModelConfig):
    """One chunked-prefill step: run ``tokens`` (B, C) at absolute positions
    [start, start+C) against the staging ``caches`` (``init_cache(...,
    staging=True)`` zeros for the first chunk), which are written in place.
    Only the first ``n_valid`` tokens are real; the padded tail writes K/V
    that no later query's mask admits.  Returns (logits (B, vocab_padded)
    at position start + n_valid - 1, caches) — the last chunk's logits are
    the prompt's next-token distribution, as ``prefill`` returns it."""
    x, _ = _inputs_to_x(params, {"tokens": tokens}, cfg)
    x, _ = apply_stack(params["stack"], x, cfg, caches=caches,
                       cache_pos=int(start))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps).to(torch.bfloat16)
    logits = unembed(params["embedding"], x[:, n_valid - 1:n_valid], cfg)
    return logits[:, 0], caches


def decode_step(params: Params, token: torch.Tensor, caches, pos,
                cfg: ModelConfig, page_table: Optional[torch.Tensor] = None):
    """One autoregressive step.  token (B,) int; pos a scalar (int or 0-d
    tensor) or (B,) per-row write positions.  With `page_table` (B, T)
    int32 the caches are page pools (see serving.paging) and pos must be
    (B,); without it they are contiguous (B, L, ...) caches, the slot
    layout (see serving.kv_arena).  The caches are written in place and
    returned."""
    pos = torch.as_tensor(pos, device=token.device)
    logits, new_caches = forward(params, token[:, None], cfg, caches=caches,
                                 cache_pos=pos, last_only=True,
                                 page_table=page_table)
    return logits[:, 0], new_caches
