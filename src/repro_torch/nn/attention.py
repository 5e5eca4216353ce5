"""Attention, GQA half — PyTorch port of `repro.nn.attention`.

Four modes, as the serving path uses them:
  * prefill (cache=None, make_cache=True): causal self-attention over the
    prompt through the flash kernel (an encoder's full attention through
    its non-causal mode), then the batch's K/V laid out as a contiguous
    cache (int8-quantized when the config says so);
  * chunked prefill (cache = a contiguous staging cache, page_table None,
    cache_pos = the chunk's int start): write the chunk's K/V at
    absolute positions [start, start+S) of the staging cache, then attend
    with a per-query mask over the whole staging cache — the reference's
    XLA einsum route (`repro.nn.attention`, its chunked branch), which no
    Pallas kernel of the reference takes;
  * slot decode (cache = a contiguous (B, L, Hkv, D) cache, page_table
    None, cache_pos a 0-d or (B,) tensor, S == 1): write this token's K/V
    at its row's position (slot = pos % window on a sliding-window ring,
    clamped to the cache as `dynamic_update_slice` clamps), then attend
    over the row.  The caller picks this branch by passing a tensor
    position (`nn.model.decode_step` without a page table), never by S;
  * paged decode (cache = page pools, page_table given, S == 1): scatter
    this token's K/V into its physical page, then attend over the row's
    pages through the paged kernel.

Both decodes attend through the paged kernel on full-attention,
softcap-free layers: slot decode views its contiguous cache as a pool of
B·L/p pages of p tokens (p the largest power of two up to 16 dividing L)
under an identity page table, with no copy, so the kernel walks only each
row's live tokens.  Routes the kernels do not take are decided by the
config, as the reference decides them: sliding-window, logit-softcap and
prefix-VLM prefills (every query also sees the P image positions, the
reference's `_mask` with `prefix_len`; the kernel has no prefix term)
run the plain masked softmax (`_softmax_attend`) up to 1,024 tokens and
`chunked_attention` past them (a windowed layer in bands of window +
q_chunk keys, `_banded_attention`); windowed (ring) or
softcapped slot decode and windowed or softcapped paged decode run the
masked softmax too (`_paged_append_gqa` gathers the row's pages first);
int8 caches are dequantized before the paged kernel.  gemma-7b and
hubert-xlarge take none of those routes; hymba's sliding-window layers
and paligemma-3b's prefill take them.

All paths accumulate in f32 and cast the result once to the activation
dtype.  Caches are updated in place (the reference returns new caches
from a donated jit argument; here the write is the same, without a copy).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.flash import flash_attention_train
from repro_torch.nn.layers import (apply_rope, partial_sum, rmsnorm,
                                   rope_angles)
from repro_torch.parallel.collectives import all_gather
from repro_torch.parallel.sharding import split_mesh

Params = Dict[str, Any]

NEG_INF = -2.0e38


def _flash(q, k, v, causal: bool) -> torch.Tensor:
    """The flash kernel's route: under autograd (training) through the
    `nn.flash` Function, whose backward is the reference's flash VJP;
    otherwise (serving, `torch.no_grad`) the kernel's wrapper alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attention_train(q, k, v, causal)
    return flash_attention(q, k, v, causal=causal)


# =================================================================== masks
def _mask(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool,
          window: int, prefix_len: int) -> torch.Tensor:
    """qpos (..., Q), kpos (..., K) -> bool (..., Q, K)."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    if causal:
        ok = k <= q
        if prefix_len:
            ok = ok | (k < prefix_len)
    else:
        ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                        dtype=torch.bool, device=qpos.device)
    if window > 0:
        ok = ok & (q - k < window)
    return ok


def _softmax_attend(q, k, v, mask, softcap: float) -> torch.Tensor:
    """q (B,Q,Hkv,G,D), k/v (B,K,Hkv,D), mask (B|1,Q,K) -> (B,Q,Hkv,G,D) f32:
    the reference's f32 einsum -> softcap -> where -> softmax -> einsum."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())


# ============================================================ chunked path
def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      prefix_len: int = 0, softcap: float = 0.0,
                      q_chunk: int = 512, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """The reference's bounded-memory prefill attention for S > 1024 on
    the routes the flash kernel does not take: a windowed layer attends
    through `_banded_attention`; otherwise (a logit softcap, a non-causal
    or prefix mask) each `q_chunk` of queries runs an f32 online softmax
    over `kv_chunk` blocks of keys, in the reference's block order.
    q (B, Sq, Hkv, G, D), k/v (B, Skv, Hkv, D) -> (B, Sq, Hkv, G, D) f32."""
    if window > 0:
        return _banded_attention(q, k, v, window=window, softcap=softcap,
                                 q_chunk=q_chunk)
    B, Sq, Hkv, G, D = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    nq, nk = -(-Sq // q_chunk), -(-Skv // kv_chunk)
    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, nq * q_chunk - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * kv_chunk - Skv))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * kv_chunk - Skv))
    dev = q.device
    outs = []
    for qi in range(nq):
        q_blk = qp[:, qi * q_chunk:(qi + 1) * q_chunk].float()
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, q_chunk), device=dev)
        acc = torch.zeros((B, Hkv, G, q_chunk, D), device=dev)
        for kj in range(nk):
            k_blk = kp[:, kj * kv_chunk:(kj + 1) * kv_chunk].float()
            v_blk = vp[:, kj * kv_chunk:(kj + 1) * kv_chunk].float()
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            ok = _mask(qpos, kpos, causal=causal, window=0,
                       prefix_len=prefix_len) & (kpos < Skv)[None, :]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_blk)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1)[:, :Sq]


def _banded_attention(q, k, v, *, window: int, softcap: float,
                      q_chunk: int) -> torch.Tensor:
    """Sliding-window prefill attention (the reference's
    `_banded_attention`): each `q_chunk` of queries attends a band of
    `window + q_chunk` keys of K/V left-padded by `window`, with an f32
    masked softmax per band — O(S·window), never an S×S mask."""
    B, Sq, Hkv, G, D = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    nq = -(-Sq // q_chunk)
    q_pad = nq * q_chunk - Sq
    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, q_pad))
    band = window + q_chunk
    kp = F.pad(k, (0, 0, 0, 0, window, q_pad))
    vp = F.pad(v, (0, 0, 0, 0, window, q_pad))
    dev = q.device
    outs = []
    for qi in range(nq):
        start = qi * q_chunk    # the band: positions [start - w, start + qc)
        k_blk = kp[:, start:start + band].float()
        v_blk = vp[:, start:start + band].float()
        qpos = start + torch.arange(q_chunk, device=dev)
        kpos = start - window + torch.arange(band, device=dev)
        ok = _mask(qpos, kpos, causal=True, window=window, prefix_len=0)
        ok = ok & ((kpos >= 0) & (kpos < Skv))[None, :]
        s = torch.einsum("bqhgd,bkhd->bhgqk",
                         qp[:, start:start + q_chunk].float(), k_blk) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, v_blk))
    return torch.cat(outs, dim=1)[:, :Sq]


# ======================================================== int8 KV cache
def _kv_quant(x: torch.Tensor):
    """Symmetric per-(token, head) int8 quantization of K/V slices.
    x: (B, S, H, D) -> (codes int8, scale f32 (B, S, H)).  torch.round
    rounds half to even, as jnp.round does.  The scale is the product with
    f32(1/127): the reference runs this inside a jit, where XLA folds its
    division by the constant 127 into that product."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) * (1.0 / 127.0)
    scale = torch.clamp(scale, min=1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def _kv_dequant(codes: torch.Tensor, scale: torch.Tensor,
                dtype=torch.bfloat16) -> torch.Tensor:
    return (codes.float() * scale[..., None]).to(dtype)


# ================================================================== module
def attention_specs(cfg: ModelConfig) -> Params:
    if cfg.attn_type == "mla":
        s = {
            "w_q": ("fsdp", "tp"), "w_dkv": ("fsdp", None),
            "w_kr": ("fsdp", None), "w_uk": ("fsdp", "tp"),
            "w_uv": ("fsdp", "tp"), "w_o": ("tp", "fsdp"),
            "kv_norm": {"scale": (None,)},
        }
    else:
        s = {"w_q": ("fsdp", "tp"), "w_k": ("fsdp", "tp"),
             "w_v": ("fsdp", "tp"), "w_o": ("tp", "fsdp")}
        if cfg.qk_norm:
            s["q_norm"] = {"scale": (None,)}
            s["k_norm"] = {"scale": (None,)}
    return s


def _gqa_qkv(params, x, cfg: ModelConfig, positions, heads=None):
    """q (B, S, Hkv, G, D), k and v (B, S, Hkv, D) of `heads` = (H, Hkv)
    query and KV heads (the config's by default; a split rank's own)."""
    B, S, _ = x.shape
    H, Hkv = heads or (cfg.n_heads, cfg.n_kv_heads)
    D = cfg.head_dim
    q = torch.matmul(x, params["w_q"].to(x.dtype))
    k = torch.matmul(x, params["w_k"].to(x.dtype))
    v = torch.matmul(x, params["w_v"].to(x.dtype))
    q = q.reshape(B, S, Hkv, H // Hkv, D)
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    cos, sin = rope_angles(positions, D, cfg.rope_theta)
    qf = apply_rope(q.reshape(B, S, H, D), cos, sin)
    k = apply_rope(k, cos, sin)
    return qf.reshape(B, S, Hkv, H // Hkv, D), k, v


def head_plan(H: int, Hkv: int, model: int, rank: int):
    """How model rank `rank` of `model` splits attention's heads: None
    when the H query heads do not divide over `model` (every model rank
    computes every head on the whole sequence and keeps its sequence
    block: the attention weights' `model` blocks are gathered), else
    (first query head, heads, the KV head each of them reads).  A rank
    holds whole query heads and the KV heads they read, repeated where
    `model` > Hkv."""
    if H % model:
        return None
    Hl = H // model
    q0 = rank * Hl
    return q0, Hl, [(q0 + i) // (H // Hkv) for i in range(Hl)]


def _split_weights(params, cfg: ModelConfig, ctx):
    """The split attention's weights on this rank: (a params dict with
    gathered matrices, (H, Hkv) of the heads it computes, whether it
    computes every head)."""
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m = ctx.size("model")
    plan = head_plan(H, Hkv, m, ctx.index("model"))

    def data(w, dim):
        return all_gather(w.to(torch.bfloat16), ctx, "data", dim)

    def whole(w, model_dim, data_dim):
        return all_gather(data(w, data_dim), ctx, "model", model_dim)

    w = {k: v for k, v in params.items() if k.endswith("_norm")}
    if plan is None:
        w.update(w_q=whole(params["w_q"], 1, 0), w_k=whole(params["w_k"], 1, 0),
                 w_v=whole(params["w_v"], 1, 0), w_o=whole(params["w_o"], 0, 1))
        return w, (H, Hkv), True
    _, Hl, kv = plan
    w.update(w_q=data(params["w_q"], 0), w_o=data(params["w_o"], 1))
    if Hkv % m == 0:                    # this rank's KV block is what it reads
        w.update(w_k=data(params["w_k"], 0), w_v=data(params["w_v"], 0))
        return w, (Hl, Hkv // m), False
    heads = sorted(set(kv))
    n = len(heads)
    grouped = Hl % n == 0 and kv == [heads[i // (Hl // n)]
                                     for i in range(Hl)]
    for name in ("w_k", "w_v"):
        full = whole(params[name], 1, 0)
        if grouped:                     # whole groups of query heads
            w[name] = full.narrow(1, heads[0] * D, n * D)
        else:                           # one KV head per query head
            cols = torch.tensor([h * D + d for h in kv for d in range(D)])
            w[name] = full.index_select(1, cols.to(full.device))
    return w, (Hl, n if grouped else Hl), False


def _mla_split_weights(params, cfg: ModelConfig, ctx):
    """MLA's weights on a split rank, as `_split_weights` gives GQA's:
    (a params dict with gathered matrices, the query heads it computes,
    whether it computes every head).  The latent projections `w_dkv` and
    `w_kr` (and `kv_norm`) are whole over `model`, so every model rank
    makes the latents of the whole sequence; `w_q`, `w_uk`, `w_uv` and
    `w_o` hold its heads' columns (rows for `w_o`), gathered over `data`.
    Where the heads do not divide over `model`, their `model` blocks are
    gathered too and the rank computes every head."""
    every = cfg.n_heads % ctx.size("model") != 0

    def data(w, dim):
        return all_gather(w.to(torch.bfloat16), ctx, "data", dim)

    w = {"kv_norm": params["kv_norm"], "w_dkv": data(params["w_dkv"], 0),
         "w_kr": data(params["w_kr"], 0)}
    for name, model_dim, data_dim in (("w_q", 1, 0), ("w_uk", 1, 0),
                                      ("w_uv", 1, 0), ("w_o", 0, 1)):
        w[name] = data(params[name], data_dim)
        if every:
            w[name] = all_gather(w[name], ctx, "model", model_dim)
    heads = cfg.n_heads if every else cfg.n_heads // ctx.size("model")
    return w, heads, every


def attention(
    params: Params,
    x: torch.Tensor,                    # (B, S, d_model)
    cfg: ModelConfig,
    *,
    layer_window: int = 0,
    prefix_len: int = 0,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[torch.Tensor] = None,
    make_cache: bool = False,
    cache_len: int = 0,
    page_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Prefill (cache=None, optionally make_cache), chunked prefill (cache
    = a contiguous staging cache, page_table None, cache_pos = the chunk's
    int start), slot decode (cache = a contiguous cache, page_table None,
    cache_pos a 0-d or (B,) tensor) or paged decode (cache = page pools,
    page_table (B, T), cache_pos (B,) per-row positions).  `prefix_len`
    leading positions are seen by every query of a causal prefill (a
    prefix-VLM's image patches).  Returns (y (B, S, d_model), new_cache);
    caches are written in place."""
    if cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: attn_type {cfg.attn_type!r} is not ported yet")
    split = (split_mesh() if cache is None and not make_cache
             and cache_pos is None else None)
    heads, every_head, S_block = None, False, 0
    if split is not None:
        # this rank's (B_l, S / model, d) block -> the whole sequence
        S_block = x.shape[1]
        x = all_gather(x, split, "model", 1)
        if cfg.attn_type == "mla":
            params, heads, every_head = _mla_split_weights(params, cfg,
                                                           split)
        else:
            params, heads, every_head = _split_weights(params, cfg, split)
    B, S, _ = x.shape
    dev = x.device
    decode = torch.is_tensor(cache_pos)
    if cache_pos is None:
        positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    elif not decode:
        # a chunk at absolute positions [start, start+S)
        positions = (int(cache_pos)
                     + torch.arange(S, device=dev))[None, :].expand(B, S)
    else:
        cache_pos = cache_pos.reshape(-1).expand(B)
        positions = cache_pos[:, None]

    if cfg.attn_type == "mla":
        o, new_cache = _mla_attention(params, x, cfg, positions=positions,
                                      cache=cache, cache_pos=cache_pos,
                                      make_cache=make_cache,
                                      cache_len=cache_len,
                                      page_table=page_table, heads=heads)
        return _project_out(o, params, x.dtype, split, every_head,
                            S_block), new_cache

    q, k, v = _gqa_qkv(params, x, cfg, positions, heads)
    H, Hkv = q.shape[2] * q.shape[3], q.shape[2]
    D = cfg.head_dim
    new_cache = None

    if cache is not None and page_table is None and decode:
        new_cache = _slot_write(cache, k, v, cfg, layer_window, cache_pos)
        o = _slot_attend(new_cache, q, cfg, layer_window, cache_pos)
    elif cache is not None and page_table is None:
        # a chunk may be one token (a prefix-cache skip can leave one); the
        # reference runs that through its decode branch at the same scalar
        # position, with the same write and mask for full-attention bf16
        new_cache = _staging_append(cache, {"k": k, "v": v}, int(cache_pos))
        kc, vc = cache["k"], cache["v"]
        kpos = torch.arange(kc.shape[1], device=dev)[None, :]
        qpos = (int(cache_pos) + torch.arange(S, device=dev))[:, None]
        valid = kpos <= qpos
        if layer_window > 0:
            valid = valid & (qpos - kpos < layer_window)
        o = _softmax_attend(q, kc, vc, valid[None], cfg.logit_softcap)
    elif cache is not None:
        if S == 1 and layer_window <= 0 and cfg.logit_softcap <= 0:
            # the paged kernel walks only each row's live tokens; int8
            # pools are dequantized first (identical values to the
            # gather-then-dequantize route)
            new_cache = _paged_scatter_gqa(cache, k, v, cfg, cache_pos,
                                           page_table)
            if cfg.kv_cache_dtype == "int8":
                kp = _kv_dequant(new_cache["k"], new_cache["k_scale"], k.dtype)
                vp = _kv_dequant(new_cache["v"], new_cache["v_scale"], v.dtype)
            else:
                kp, vp = new_cache["k"], new_cache["v"]
            o = paged_attention(q[:, 0].reshape(B, H, D), kp, vp,
                                page_table, cache_pos)
            o = o.reshape(B, 1, Hkv, H // Hkv, D)
        else:
            kc, vc, new_cache = _paged_append_gqa(cache, k, v, cfg,
                                                  cache_pos, page_table)
            kpos = torch.arange(kc.shape[1], device=dev)[None, :]
            cp = cache_pos.long()[:, None]
            valid = kpos <= cp
            if layer_window > 0:
                valid = valid & (kpos > cp - layer_window)
            o = _softmax_attend(q, kc, vc, valid[:, None, :],
                                cfg.logit_softcap)
    else:
        if (layer_window <= 0 and cfg.logit_softcap <= 0
                and not (cfg.causal and prefix_len)):
            # causal prefix-free layers, and an encoder's full attention
            o = _flash(q.reshape(B, S, H, D), k, v, cfg.causal)
            o = o.reshape(B, S, Hkv, H // Hkv, D)
        elif S <= 1024:
            mask = _mask(positions, positions, causal=cfg.causal,
                         window=layer_window, prefix_len=prefix_len)
            o = _softmax_attend(q, k, v, mask, cfg.logit_softcap)
        else:
            o = chunked_attention(q, k, v, causal=cfg.causal,
                                  window=layer_window if cfg.causal else 0,
                                  prefix_len=prefix_len,
                                  softcap=cfg.logit_softcap,
                                  q_chunk=cfg.attn_q_chunk,
                                  kv_chunk=cfg.attn_kv_chunk)
        if make_cache:
            new_cache = _make_cache(k, v, cfg, layer_window, cache_len or S)

    return _project_out(o, params, x.dtype, split, every_head,
                        S_block), new_cache


def _project_out(o, params, dt, split, every_head: bool, S_block: int):
    """The heads' outputs o (B, S, H, ·) through `w_o` -> (B, S, d_model).
    On the split path: a rank that computed every head keeps its sequence
    block; a rank that computed its own heads holds a partial sum, which
    is reduce-scattered over `model` into its sequence block."""
    B, S = o.shape[:2]
    o = o.to(dt).reshape(B, S, -1)
    if every_head:
        o = o.narrow(1, split.index("model") * S_block, S_block)
    if split is not None and not every_head:
        return partial_sum(o, params["w_o"].to(dt), split)
    return torch.matmul(o, params["w_o"].to(dt))


def _make_cache(k, v, cfg: ModelConfig, layer_window: int, L: int):
    """Lay the prefill's K/V (B, S, Hkv, D) out as a length-L cache:
    positions [0, S) filled, the rest zero; sliding-window layers keep the
    last `window` tokens at slot = pos % window; int8 configs store codes
    plus per-(token, head) scales."""
    B, S = k.shape[:2]
    ring = layer_window if 0 < layer_window <= L else 0
    Lc = ring if ring else L
    int8 = cfg.kv_cache_dtype == "int8"
    shape = (B, Lc, cfg.n_kv_heads, cfg.head_dim)
    if int8:
        k_st, ks_full = _kv_quant(k)
        v_st, vs_full = _kv_quant(v)
        kc = torch.zeros(shape, dtype=torch.int8, device=k.device)
        ksc = torch.zeros(shape[:3], dtype=torch.float32, device=k.device)
        vsc = torch.zeros_like(ksc)
    else:
        k_st, v_st = k, v
        kc = torch.zeros(shape, dtype=k.dtype, device=k.device)
    vc = torch.zeros_like(kc)
    if ring:
        n_keep = min(S, ring)
        slots = torch.arange(S - n_keep, S, device=k.device) % ring
        kc[:, slots] = k_st[:, -n_keep:]
        vc[:, slots] = v_st[:, -n_keep:]
        if int8:
            ksc[:, slots] = ks_full[:, -n_keep:]
            vsc[:, slots] = vs_full[:, -n_keep:]
    else:
        kc[:, :S] = k_st
        vc[:, :S] = v_st
        if int8:
            ksc[:, :S] = ks_full
            vsc[:, :S] = vs_full
    cache = {"k": kc, "v": vc}
    if int8:
        cache.update({"k_scale": ksc, "v_scale": vsc})
    return cache


def _slot_write(cache, k, v, cfg: ModelConfig, layer_window: int, pos):
    """Slot-decode append (the reference's `_dus_batch` at per-row
    positions): write this step's K/V (B, 1, Hkv, D), quantized per token
    for int8 caches, at each row's slot in place.  A sliding-window layer
    whose cache is its ring (0 < window <= L) writes slot = pos % window;
    other layers write at pos, clamped into the cache as
    `dynamic_update_slice` clamps it (a freed row's stale position is
    decoded too).  Returns the cache."""
    L = cache["k"].shape[1]
    ring = layer_window if 0 < layer_window <= L else 0
    pos = pos.long()
    slot = (torch.remainder(pos, ring) if ring
            else torch.clamp(pos, 0, L - 1))
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    return _row_write(cache, new, slot)


def _row_write(cache, new, slot):
    """Write each of this step's (B, 1, ...) entries `new` at its row's
    `slot` (B,) of the contiguous cache leaf of the same name, in place;
    returns the cache."""
    rows = torch.arange(slot.shape[0], device=slot.device)
    for name, val in new.items():
        cache[name][rows, slot] = val[:, 0].to(cache[name].dtype)
    return cache


@functools.lru_cache(maxsize=None)
def _identity_table(rows: int, pages: int, device: torch.device):
    """int32 (rows, pages) table mapping row b's block i to page
    b·pages + i: a contiguous (rows, pages·p, ...) cache seen as a pool."""
    return torch.arange(rows * pages, dtype=torch.int32,
                        device=device).view(rows, pages)


def _page_view(L: int) -> int:
    """Page size of a length-L cache seen as a pool: the largest power of
    two up to 16 that divides L."""
    return math.gcd(L, 16)


def _slot_attend(cache, q, cfg: ModelConfig, layer_window: int, pos):
    """Attention of one decode token per row over a contiguous cache that
    `_slot_write` has written.  Full-attention, softcap-free layers go
    through the paged kernel over the cache seen as pages (`_page_view`,
    `_identity_table`; a view, no copy; int8 caches dequantized first);
    its plain version on the CPU is the reference's f32 masked einsum over
    the same L keys.  Ring and softcap layers run that einsum here, with
    the reference's ring mask.  Returns (B, 1, Hkv, G, D) f32 or q's
    dtype."""
    B = q.shape[0]
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = cache["k"].shape[1]
    if cfg.kv_cache_dtype == "int8":
        kc = _kv_dequant(cache["k"], cache["k_scale"], q.dtype)
        vc = _kv_dequant(cache["v"], cache["v_scale"], q.dtype)
    else:
        kc, vc = cache["k"], cache["v"]
    if layer_window <= 0 and cfg.logit_softcap <= 0:
        p = _page_view(L)
        table = _identity_table(B, L // p, kc.device)
        o = paged_attention(q[:, 0].reshape(B, H, D),
                            kc.view(B * L // p, p, Hkv, D),
                            vc.view(B * L // p, p, Hkv, D), table, pos)
        return o.reshape(B, 1, Hkv, H // Hkv, D)
    ring = layer_window if 0 < layer_window <= L else 0
    kpos = torch.arange(L, device=kc.device)[None, :]
    cp = pos.long()[:, None]
    if ring:
        # the absolute position slot i holds: the largest p <= pos with
        # p = i (mod ring)
        abs_pos = cp - torch.remainder(cp - kpos, ring)
        valid = (abs_pos >= 0) & (abs_pos > cp - ring)
    else:
        valid = kpos <= cp
    return _softmax_attend(q, kc, vc, valid[:, None, :], cfg.logit_softcap)


def _staging_append(cache, new, start: int):
    """Chunked-prefill append (the reference's `_dus_batch` at a scalar
    start): write each of this chunk's (B, S, ...) entries `new` (K/V, or
    MLA's latents) at absolute positions [start, start+S) of the staging
    cache leaf of the same name, in place; returns the cache.  Staging
    holds raw K/V in the activation dtype for every tenant (int8 tenants
    quantize once, at page install).  The reference's
    dynamic_update_slice would clamp a start that spills past the cache
    and overwrite earlier positions; here that raises."""
    S = next(iter(new.values())).shape[1]
    L = next(iter(cache.values())).shape[1]
    if not 0 <= start <= L - S:
        raise ValueError(f"chunk of {S} tokens at {start} does not fit a "
                         f"staging cache of {L}")
    for name, val in new.items():
        cache[name][:, start:start + S] = val.to(cache[name].dtype)
    return cache


def _paged_ops(pool_leaf, cache_pos, page_table):
    """Scatter/gather closures over one page pool shape family.

    Pool leaves carry (P, page, ...); cache_pos (B,) is each row's write
    position and page_table (B, T) its block→physical-page map.  `scatter`
    writes this step's (B, 1, ...) entries at (physical page, offset) in
    place; `gather` rebuilds the row-ordered (B, T·page, ...) view.

    Each active row's target page is exclusively owned (the arena COWs
    shared pages before the step), so the scatter rows never collide except
    on the reserved scratch page that inactive rows aim at — whose contents
    are never read for an active row.  The block index is clamped to the
    table (as the reference's gather clamps): an inactive row may carry a
    stale position one past its last page.
    """
    page = pool_leaf.shape[1]
    B, T = page_table.shape
    pos = cache_pos.long()
    block = torch.clamp(pos // page, max=T - 1)
    offset = pos % page
    phys = page_table[torch.arange(B, device=page_table.device), block].long()

    def scatter(pool, new):
        pool[phys, offset] = new[:, 0].to(pool.dtype)
        return pool

    def gather(pool):
        return pool[page_table.long()].reshape((B, T * page) + pool.shape[2:])

    return scatter, gather


def _paged_append_gqa(cache, k, v, cfg: ModelConfig, cache_pos, page_table):
    """Paged decode append + gather for GQA caches: k/v pools
    (P, page, Hkv, D) (+ int8 scales (P, page, Hkv)); k/v are this step's
    (B, 1, Hkv, D) projections.  Returns (kc, vc, new_cache) with kc/vc
    gathered to (B, T·page, Hkv, D) in logical position order."""
    new_cache = _paged_scatter_gqa(cache, k, v, cfg, cache_pos, page_table)
    _, gather = _paged_ops(cache["k"], cache_pos, page_table)
    if cfg.kv_cache_dtype == "int8":
        kc = _kv_dequant(gather(new_cache["k"]), gather(new_cache["k_scale"]),
                         k.dtype)
        vc = _kv_dequant(gather(new_cache["v"]), gather(new_cache["v_scale"]),
                         v.dtype)
    else:
        kc, vc = gather(new_cache["k"]), gather(new_cache["v"])
    return kc, vc, new_cache


def _paged_scatter_gqa(cache, k, v, cfg: ModelConfig, cache_pos, page_table):
    """Write this step's K/V (quantized for int8 pools) into the pools in
    place and return the cache dict, without materializing the gathered
    (B, T·page, ...) view — the paged kernel reads the pools through the
    page table itself."""
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    return _paged_scatter(cache, new, cache_pos, page_table)


# ==================================================================== MLA
def _mla_absorbed(params, q_nope, q_rope, ckv, kr, valid, cfg: ModelConfig):
    """Absorbed-matmul decode attention (DeepSeek-V2's low-rank KV) in the
    reference's order: W_uk folded into the query, the score
    q_eff·c_kv + q_rope·k_rope and only then the scale, the masked softmax,
    the context over the latents and W_uv last.  q_nope/q_rope (B, S, H,
    ·), ckv (B, L, r) and kr (B, L, rope) the latent cache in position
    order, valid (B|1, S, L) -> (B, S, H, v_head_dim) f32.

    The math runs in f64 and rounds to f32 at the end.  Slot decode
    attends over the slot's row (max_seq positions) and paged decode over
    the gathered table (T·page positions); an f32 reduction takes its
    terms in an order set by that length, so in f32 the masked tail moved
    the result (on the CPU at 302 against 552 positions; on the card the
    slot and paged routes' bf16 outputs came out up to 2 ulps apart at
    layer 0 of deepseek-v2-lite-16b and parted greedy tokens at
    near-ties).  In f64 every length rounds to the same f32."""
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    f64 = torch.float64
    w_uk = params["w_uk"].to(f64).reshape(r, H, nope)
    w_uv = params["w_uv"].to(f64).reshape(r, H, cfg.v_head_dim)
    ckv = ckv.to(f64)
    q_eff = torch.einsum("bshn,rhn->bshr", q_nope.to(f64), w_uk)
    s = torch.einsum("bshr,bkr->bhsk", q_eff, ckv)
    s = s + torch.einsum("bshd,bkd->bhsk", q_rope.to(f64), kr.to(f64))
    s = s * (1.0 / math.sqrt(nope + rope_d))
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhsk,bkr->bshr", p, ckv)
    return torch.einsum("bshr,rhv->bshv", ctx, w_uv).float()


def _mla_attention(params, x, cfg: ModelConfig, *, positions, cache,
                   cache_pos, make_cache, cache_len, page_table, heads=None):
    """MLA (the reference's `_mla_attention`): the cache holds the latents
    c_kv (rank kv_lora_rank, RMS-normed) and the shared rotary key k_rope.

      * prefill materializes per-head K (nope ‖ k_rope broadcast, D 192 at
        full width) and V (D 128) and attends through the flash kernel,
        V zero-padded to K's width (zero columns add nothing to the others,
        and the scale stays 1/sqrt(D_k));
      * a chunk (an int cache_pos, S > 1) appends its latents to the
        staging cache and materializes K/V from the whole of it, attending
        through the reference's f32 masked einsum;
      * one token against a cache — slot decode (a tensor position), paged
        decode (a page table) and a one-token chunk, which the reference
        sends to the same branch — runs the absorbed f32 math
        (`_mla_absorbed`) over the latents in position order, with no
        kernel: the paged route gathers the row's pages first.

    There is no int8 latent cache: the reference ignores kv_cache_dtype
    for MLA.  `heads` is the count of query heads `params` hold (a split
    rank's own; the config's by default).  Returns (the heads' outputs
    (B, S, heads, v_head_dim), new_cache); `attention` projects them."""
    B, S, _ = x.shape
    H = heads or cfg.n_heads
    nope, rope_d, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = x.dtype
    q = torch.matmul(x, params["w_q"].to(dt)).reshape(B, S, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_angles(positions, rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    c_kv = rmsnorm(params["kv_norm"], torch.matmul(x, params["w_dkv"].to(dt)),
                   cfg.norm_eps)
    k_rope = torch.matmul(x, params["w_kr"].to(dt))
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0]
    new = {"c_kv": c_kv, "k_rope": k_rope}

    if cache is not None and S == 1:
        if page_table is not None:
            new_cache = _paged_scatter(cache, new, cache_pos, page_table)
            _, gather = _paged_ops(cache["c_kv"], cache_pos, page_table)
            ckv, kr = gather(new_cache["c_kv"]), gather(new_cache["k_rope"])
        else:
            # at each row's position, clamped into the cache as
            # dynamic_update_slice clamps
            new_cache = _row_write(cache, new, torch.clamp(
                positions[:, 0].long(), 0, cache["c_kv"].shape[1] - 1))
            ckv, kr = new_cache["c_kv"], new_cache["k_rope"]
        kpos = torch.arange(ckv.shape[1], device=x.device)[None, :]
        valid = (kpos <= positions[:, :1])[:, None, :]
        o = _mla_absorbed(params, q_nope, q_rope, ckv, kr, valid, cfg)
    else:
        new_cache = None
        if cache is not None:
            # a chunk: its latents into the staging cache, K/V from all of it
            new_cache = _staging_append(cache, new, int(cache_pos))
            c_all, kr_all = cache["c_kv"], cache["k_rope"]
        else:
            c_all, kr_all = c_kv, k_rope
        Sc = c_all.shape[1]
        k_nope = torch.matmul(c_all, params["w_uk"].to(dt)).reshape(
            B, Sc, H, nope)
        vv = torch.matmul(c_all, params["w_uv"].to(dt)).reshape(B, Sc, H,
                                                                vdim)
        k = torch.cat([k_nope, kr_all[:, :, None, :].expand(B, Sc, H, rope_d)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        if cache is not None:
            kpos = torch.arange(Sc, device=x.device)[None, :]
            mask = (kpos <= positions[0][:, None])[None]
            o = _softmax_attend(qq[:, :, :, None], k, vv, mask,
                                0.0)[:, :, :, 0]
        elif cfg.causal:
            vp = torch.nn.functional.pad(vv, (0, nope + rope_d - vdim))
            o = _flash(qq, k, vp, True)[..., :vdim]
        else:
            mask = _mask(positions, positions, causal=False, window=0,
                         prefix_len=0)
            o = _softmax_attend(qq[:, :, :, None], k, vv, mask,
                                0.0)[:, :, :, 0]
        if make_cache:
            L = cache_len or S
            new_cache = {
                "c_kv": torch.zeros((B, L, cfg.kv_lora_rank), dtype=dt,
                                    device=x.device),
                "k_rope": torch.zeros((B, L, rope_d), dtype=dt,
                                      device=x.device)}
            for name, val in new.items():
                new_cache[name][:, :S] = val

    return o, new_cache


def _paged_scatter(cache, new, cache_pos, page_table):
    """Write this step's (B, 1, ...) entries `new` (K/V, int8 codes and
    scales, or MLA's latents) into the page pools of the same names, in
    place; returns the cache."""
    scatter, _ = _paged_ops(next(iter(cache.values())), cache_pos,
                            page_table)
    for name, val in new.items():
        scatter(cache[name], val)
    return cache
