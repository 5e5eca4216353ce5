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
from repro_torch.nn.moe import init_moe
from repro_torch.nn.transformer import apply_stack, layer_kind, stack_plan

Params = Dict[str, Any]


# ------------------------------------------------------------------ init
# leaves the model uses in f32 (the router's softmax, MLA's absorbed
# decode); every other matrix is cast to the bf16 activations at each use
F32_LEAVES = ("router", "w_uk", "w_uv")


def _attn_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Matrix shapes of one attention module (fan-in is dim 0)."""
    d = cfg.d_model
    if cfg.attn_type == "mla":
        H, r = cfg.n_heads, cfg.kv_lora_rank
        return {"w_q": (d, H * (cfg.qk_nope_dim + cfg.qk_rope_dim)),
                "w_dkv": (d, r), "w_kr": (d, cfg.qk_rope_dim),
                "w_uk": (r, H * cfg.qk_nope_dim),
                "w_uv": (r, H * cfg.v_head_dim),
                "w_o": (H * cfg.v_head_dim, d)}
    return {"w_q": (d, cfg.q_dim), "w_k": (d, cfg.kv_dim),
            "w_v": (d, cfg.kv_dim), "w_o": (cfg.q_dim, d)}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights with the reference's tree, shapes and scales
    (`repro.nn.model.init_params`): matrices N(0, 1)/sqrt(fan_in) (axis 0,
    or axis 1 of the (E, ·, ·) expert stacks), the embedding N(0, 1)·0.02,
    norm scales 1.  Drawn from a `torch.Generator` seeded with `seed` on
    `device` (the draws differ from jax's); matrices are stored in bf16,
    norm scales and the `F32_LEAVES` in f32 (see `repro_torch.weights`).
    Dense GQA (qk_norm too), MLA and MoE stacks are ported."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, scale, dtype):
        out = torch.empty(shape, dtype=dtype, device=dev)
        # one f32 draw per leading slice keeps the f32 scratch small
        for row in out.view(-1, *shape[-2:]) if len(shape) > 2 else [out]:
            row.copy_(torch.randn(row.shape, generator=gen, device=dev)
                      .mul_(scale))
        return out

    for start, _, _ in stack_plan(cfg):
        if layer_kind(cfg, start) != "attn" or cfg.input_mode != "tokens":
            raise NotImplementedError(f"{cfg.name}: {cfg.family} stacks are "
                                      "not ported yet")
    emb = {"table": draw((cfg.vocab_padded, cfg.d_model), 0.02,
                         torch.bfloat16)}
    if not cfg.tie_embeddings:
        emb["head"] = draw((cfg.d_model, cfg.vocab_padded),
                           1.0 / math.sqrt(cfg.d_model), torch.bfloat16)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    segments: List[Params] = []
    for start, length, scanned in stack_plan(cfg):
        lead = (length,) if scanned else ()

        def normal(shape, scale, dtype=torch.bfloat16):
            return draw(lead + shape, scale, dtype)

        attn = {name: normal(shape, 1.0 / math.sqrt(shape[0]),
                             torch.float32 if name in F32_LEAVES
                             else torch.bfloat16)
                for name, shape in _attn_shapes(cfg).items()}
        if cfg.attn_type == "mla":
            attn["kv_norm"] = {"scale": ones(*lead, cfg.kv_lora_rank)}
        elif cfg.qk_norm:
            attn["q_norm"] = {"scale": ones(*lead, cfg.head_dim)}
            attn["k_norm"] = {"scale": ones(*lead, cfg.head_dim)}
        block = {"norm1": {"scale": ones(*lead, cfg.d_model)}, "attn": attn,
                 "norm2": {"scale": ones(*lead, cfg.d_model)}}
        if cfg.layer_is_moe[start]:
            block["moe"] = init_moe(cfg, normal)
        else:
            d, f = cfg.d_model, cfg.d_ff
            block["mlp"] = {"w_up": normal((d, f), 1.0 / math.sqrt(d)),
                            "w_down": normal((f, d), 1.0 / math.sqrt(f))}
            if cfg.gated:
                block["mlp"]["w_gate"] = normal((d, f), 1.0 / math.sqrt(d))
        segments.append(block)
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
            ) -> Tuple[torch.Tensor, Optional[Any], torch.Tensor]:
    """tokens (B, S) -> (logits (B, S|1, vocab_padded), new_caches, the
    MoE layers' summed router aux loss (f32, 0 for dense stacks)).
    ``last_only`` restricts the unembed to the final position."""
    x, _ = _inputs_to_x(params, {"tokens": tokens}, cfg)
    x, new_caches, aux = apply_stack(
        params["stack"], x, cfg, caches=caches, cache_pos=cache_pos,
        make_cache=make_cache, cache_len=cache_len, page_table=page_table)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps).to(torch.bfloat16)
    if last_only:
        x = x[:, -1:]
    return unembed(params["embedding"], x, cfg), new_caches, aux


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            cache_len: int):
    """Run the prompt (B, S) through the model, returning
    (next_token_logits (B, vocab_padded), caches of length cache_len)."""
    logits, caches, _ = forward(params, tokens, cfg, make_cache=True,
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
    MLA layers cache their latents, {c_kv (..., batch, cache_len,
    kv_lora_rank), k_rope (..., rope)} in ``dtype`` (the reference has no
    int8 latent cache).  Attention stacks only: recurrent caches are not
    ported."""
    dev = resolve_device(device)
    int8 = cfg.kv_cache_dtype == "int8" and not staging
    caches = []
    for start, length, scanned in stack_plan(cfg):
        kind = layer_kind(cfg, start)
        if kind != "attn":
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): {kind} caches are not ported "
                "yet")
        lead = (length,) if scanned else ()
        if cfg.attn_type == "mla":
            caches.append({"attn": {
                "c_kv": torch.zeros(lead + (batch, cache_len,
                                            cfg.kv_lora_rank),
                                    dtype=dtype, device=dev),
                "k_rope": torch.zeros(lead + (batch, cache_len,
                                              cfg.qk_rope_dim),
                                      dtype=dtype, device=dev)}})
            continue
        window = cfg.window_for_layer(start)
        L = min(window, cache_len) if window and not staging else cache_len
        shape = lead + (batch, L, cfg.n_kv_heads, cfg.head_dim)
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
    x, _, _ = apply_stack(params["stack"], x, cfg, caches=caches,
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
    logits, new_caches, _ = forward(params, token[:, None], cfg,
                                    caches=caches, cache_pos=pos,
                                    last_only=True, page_table=page_table)
    return logits[:, 0], new_caches
