"""Top-level model — PyTorch port of `repro.nn.model` (attention, hybrid
attention ∥ Mamba, and xLSTM stacks): embeddings → stack → norm →
logits, the training loss (`lm_loss`), and the serving entry points:
monolithic prefill, chunked prefill into a staging cache, and decode over
contiguous (slot) or paged caches.

Input contract of `forward` and `prefill` (the `batch` dict), as the
reference's:
  tokens        (B, S) int           — LM families
  embeds        (B, S, d_model)      — stubbed modality frontend (hubert)
  patch_embeds  (B, P, d_model)      — stubbed vision frontend (paligemma)
  loss_mask     (B, S) float optional — 1.0 where `lm_loss` counts a position
  targets       (B, S) int optional   — explicit labels (encoder models)
`chunk_prefill` and `decode_step` take token tensors, as the reference's
do; a prefix-VLM model reaches them with its text tokens alone.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import (embed, embedding_specs, rmsnorm,
                                   rmsnorm_specs, unembed, vocab_block)
from repro_torch.nn.moe import init_moe
from repro_torch.nn.ssm import (init_mamba_cache, init_mlstm_cache,
                                init_slstm_cache)
from repro_torch.nn.transformer import (apply_stack, layer_kind, stack_plan,
                                        stack_specs)
from repro_torch.parallel.collectives import (all_gather, all_reduce,
                                              all_reduce_, all_reduce_max,
                                              psum)
from repro_torch.parallel.sharding import split_mesh

Params = Dict[str, Any]


# ------------------------------------------------------------------ init
# leaves the model uses in f32 (the router's softmax, MLA's absorbed
# decode, Mamba's dt bias and A, the mLSTM gate bias, the sLSTM recurrent
# matrix and gate bias); every other matrix is cast to the bf16
# activations at each use
F32_LEAVES = ("router", "w_uk", "w_uv", "dt_bias", "A_log", "if_bias",
              "r_gates", "gate_bias")


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
    Dense GQA (qk_norm too), MLA, MoE, hybrid (attention ∥ Mamba) and
    xLSTM stacks; an untied `head` where the config unties it.  On the
    `meta` device nothing is drawn: the tree holds shapes and dtypes only
    (`launch.steps.abstract_params`)."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev)
    if gen is not None:
        gen.manual_seed(seed)

    def draw(shape, scale, dtype):
        out = torch.empty(shape, dtype=dtype, device=dev)
        if gen is None:
            return out
        # one f32 draw per leading slice keeps the f32 scratch small
        for row in out.view(-1, *shape[-2:]) if len(shape) > 2 else [out]:
            row.copy_(torch.randn(row.shape, generator=gen, device=dev)
                      .mul_(scale))
        return out

    emb = {"table": draw((cfg.vocab_padded, cfg.d_model), 0.02,
                         torch.bfloat16)}
    if not cfg.tie_embeddings:
        emb["head"] = draw((cfg.d_model, cfg.vocab_padded),
                           1.0 / math.sqrt(cfg.d_model), torch.bfloat16)

    segments: List[Params] = []
    for start, length, scanned in stack_plan(cfg):
        lead = (length,) if scanned else ()

        def normal(shape, scale, dtype=torch.bfloat16):
            return draw(lead + shape, scale, dtype)

        def const(value, *shape):
            return torch.full(lead + shape, float(value), device=dev)

        kind = layer_kind(cfg, start)
        if kind in ("mlstm", "slstm"):
            cell = (_init_mlstm if kind == "mlstm" else _init_slstm)(
                cfg, normal, const)
            segments.append({"norm1": {"scale": const(1.0, cfg.d_model)},
                             "cell": cell})
            continue
        attn = {name: normal(shape, 1.0 / math.sqrt(shape[0]),
                             torch.float32 if name in F32_LEAVES
                             else torch.bfloat16)
                for name, shape in _attn_shapes(cfg).items()}
        if cfg.attn_type == "mla":
            attn["kv_norm"] = {"scale": const(1.0, cfg.kv_lora_rank)}
        elif cfg.qk_norm:
            attn["q_norm"] = {"scale": const(1.0, cfg.head_dim)}
            attn["k_norm"] = {"scale": const(1.0, cfg.head_dim)}
        block = {"norm1": {"scale": const(1.0, cfg.d_model)}, "attn": attn,
                 "norm2": {"scale": const(1.0, cfg.d_model)}}
        if kind == "hybrid":
            block["mamba"] = _init_mamba(cfg, normal, const)
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


def param_specs(cfg: ModelConfig) -> Params:
    """`init_params`' tree with each leaf's logical axes in its place."""
    return {
        "embedding": embedding_specs(cfg),
        "stack": stack_specs(cfg),
        "final_norm": rmsnorm_specs(),
    }


def _init_mamba(cfg: ModelConfig, normal, const) -> Params:
    """Mamba's params (`repro.nn.ssm.init_mamba`): dt_bias 0, A_log =
    log(1..N) per channel, D 1, conv N(0, 1)·0.1.  `normal(shape, scale,
    dtype)` draws a leaf, `const(value, *shape)` fills an f32 one."""
    d, N = cfg.d_model, cfg.ssm_state
    di = cfg.ssm_expand * d
    dt_rank = max(d // 16, 8)
    a_log = const(0.0, di, N)
    a_log += torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                    device=a_log.device))
    return {"w_in": normal((d, 2 * di), 1.0 / math.sqrt(d)),
            "conv": normal((cfg.ssm_conv_width, di), 0.1),
            "w_xproj": normal((di, dt_rank + 2 * N), 1.0 / math.sqrt(di)),
            "w_dt": normal((dt_rank, di), 1.0 / math.sqrt(dt_rank)),
            "dt_bias": const(0.0, di), "A_log": a_log,
            "D": const(1.0, di).to(torch.bfloat16),
            "w_out": normal((di, d), 1.0 / math.sqrt(di))}


def _init_mlstm(cfg: ModelConfig, normal, const) -> Params:
    """mLSTM's params (`repro.nn.ssm.init_mlstm`): the input gate's bias
    0, the forget gate's 3."""
    d, H = cfg.d_model, cfg.ssm_heads
    di = cfg.ssm_expand * d
    s_d, s_di = 1.0 / math.sqrt(d), 1.0 / math.sqrt(di)
    return {"w_in": normal((d, 2 * di), s_d),
            "w_q": normal((di, di), s_di), "w_k": normal((di, di), s_di),
            "w_v": normal((di, di), s_di), "w_if": normal((di, 2 * H), s_di),
            "if_bias": torch.cat([const(0.0, H), const(3.0, H)], dim=-1),
            "norm": {"scale": const(1.0, di)},
            "w_out": normal((di, d), s_di)}


def _init_slstm(cfg: ModelConfig, normal, const) -> Params:
    """sLSTM's params (`repro.nn.ssm.init_slstm`): the recurrent matrix
    N(0, 1)/sqrt(D) per head in f32, the gate bias 2 on the second
    quarter."""
    d, H = cfg.d_model, cfg.ssm_heads
    D = d // H
    return {"w_gates": normal((d, 4 * d), 1.0 / math.sqrt(d)),
            "r_gates": normal((H, D, 4 * D), 1.0 / math.sqrt(D),
                              torch.float32),
            "gate_bias": torch.cat([const(0.0, d), const(2.0, d),
                                    const(0.0, 2 * d)], dim=-1),
            "norm": {"scale": const(1.0, d)},
            "w_out": normal((d, d), 1.0 / math.sqrt(d))}


# --------------------------------------------------------------- forward
def _inputs_to_x(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, int]:
    """The model's input stream from a batch dict: (x, prefix_len).  An
    embeddings model takes `embeds` cast to bf16; a prefix-VLM batch that
    carries `patch_embeds` puts them, cast to the token dtype, before the
    token embeddings (prefix_len = P); anything else embeds `tokens` (on
    the split path, this rank's (B_l, S / model, d) sequence block)."""
    if cfg.input_mode == "embeddings":
        return batch["embeds"].to(torch.bfloat16), 0
    if cfg.input_mode == "prefix_vlm" and "patch_embeds" in batch:
        tok = embed(params["embedding"], batch["tokens"], cfg)
        pat = batch["patch_embeds"].to(tok.dtype)
        return torch.cat([pat, tok], dim=1), pat.shape[1]
    return embed(params["embedding"], batch["tokens"], cfg), 0


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, caches=None, cache_pos=None, make_cache: bool = False,
            cache_len: int = 0, last_only: bool = False, page_table=None
            ) -> Tuple[torch.Tensor, Optional[Any], torch.Tensor]:
    """batch (see the module docstring) -> (logits (B, P+S|1,
    vocab_padded), new_caches, the MoE layers' summed router aux loss
    (f32, 0 for dense stacks)).  ``last_only`` restricts the unembed to
    the final position."""
    x, prefix_len = _inputs_to_x(params, batch, cfg)
    x, new_caches, aux = apply_stack(
        params["stack"], x, cfg, prefix_len=prefix_len, caches=caches,
        cache_pos=cache_pos, make_cache=make_cache, cache_len=cache_len,
        page_table=page_table)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps).to(torch.bfloat16)
    if last_only:
        x = x[:, -1:]
    return unembed(params["embedding"], x, cfg), new_caches, aux


def _chunked_ce(params: Params, x: torch.Tensor, targets: torch.Tensor,
                loss_mask: torch.Tensor, cfg: ModelConfig, chunk: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's `_chunked_ce`: mean cross-entropy over the counted
    positions, the (B, S, vocab) logits made `chunk` positions at a time.
    Each chunk's bf16 logits are cast to f32, the padded vocab masked to
    -1e30, and the target's logit picked by a masked sum (the reference's
    vocab-sharding-friendly pick).  x (B, S, d) bf16, targets (B, S) int,
    loss_mask (B, S) f32 -> (mean CE, count of counted positions), f32.
    On the split path (`_split_ce`) x is the rank's batch block."""
    ctx = split_mesh()
    if ctx is not None:
        return _split_ce(params, x, targets, loss_mask, cfg, ctx, chunk)
    S = x.shape[1]
    dev = x.device
    vocab_iota = torch.arange(cfg.vocab_padded, device=dev)
    vocab_ok = vocab_iota < cfg.vocab
    tot = torch.zeros((), device=dev)
    cnt = torch.zeros((), device=dev)
    for s0 in range(0, S, chunk):
        xb, tb = x[:, s0:s0 + chunk], targets[:, s0:s0 + chunk]
        mb = loss_mask[:, s0:s0 + chunk]
        logits = unembed(params["embedding"], xb, cfg).float()
        logits = torch.where(vocab_ok, logits, torch.full_like(logits, -1e30))
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.sum(torch.where(vocab_iota == tb[..., None], logits,
                                       torch.zeros_like(logits)), dim=-1)
        tot = tot + torch.sum((lse - picked) * mb)
        cnt = cnt + torch.sum(mb)
    return tot / torch.clamp_min(cnt, 1.0), cnt


def _split_ce(params, x, targets, loss_mask, cfg: ModelConfig, ctx,
              chunk: int):
    """`_chunked_ce` on a split rank: x (B_l, S, d) its batch block over
    the whole sequence, its logits its vocab block.  The row max, the sum
    of exponentials and the target's logit are reduced over `model` (the
    reduction the reference's one-hot pick leaves GSPMD); the rank counts
    the positions of its own sequence block, and the loss is the sum of
    the ranks' shares over the count of the whole batch, on every rank."""
    B, S = targets.shape
    dev = x.device
    table = vocab_block(params["embedding"], ctx)            # (d, V / m)
    rows = table.shape[1]
    vocab_iota = ctx.index("model") * rows + torch.arange(rows, device=dev)
    vocab_ok = vocab_iota < cfg.vocab
    # the sequence block of the rank's residual stream: (S + 1) / model
    blk = (S + 1) // ctx.size("model")
    pos = torch.arange(S, device=dev)
    own = ((pos >= ctx.index("model") * blk)
           & (pos < (ctx.index("model") + 1) * blk)).float()
    tot = torch.zeros((), device=dev)
    cnt = torch.zeros((), device=dev)
    for s0 in range(0, S, chunk):
        xb, tb = x[:, s0:s0 + chunk], targets[:, s0:s0 + chunk]
        mb = loss_mask[:, s0:s0 + chunk]
        logits = torch.matmul(xb, table).float()
        logits = torch.where(vocab_ok, logits, torch.full_like(logits, -1e30))
        mx = all_reduce_max(torch.amax(logits, dim=-1), ctx, "model")
        se = all_reduce(torch.sum(torch.exp(logits - mx[..., None]), dim=-1),
                        ctx, "model")
        lse = mx + torch.log(se)
        picked = all_reduce(torch.sum(torch.where(
            vocab_iota == tb[..., None], logits, torch.zeros_like(logits)),
            dim=-1), ctx, "model")
        tot = tot + torch.sum((lse - picked) * mb * own[s0:s0 + chunk])
        cnt = cnt + torch.sum(mb)
    batch = ("pod", "data") if ctx.has_pod else ("data",)
    cnt = cnt.detach()
    for name in batch:
        all_reduce_(cnt, ctx.group(name), axis=name)
    tot = psum(tot, ctx, ctx.axis_names)
    return tot / torch.clamp_min(cnt, 1.0), cnt


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's training loss: (loss, {"ce", "aux", "tokens"}), loss
    = ce + router_aux_weight · aux.  Token models predict each next token
    (a prefix VLM over its text positions only); an encoder predicts
    `targets` where `loss_mask` counts.  Differentiable in `params`; with
    `cfg.remat` every block is rematerialized in the backward pass.

    On the split path (`parallel.sharding.split_mesh`, which
    `launch.steps.make_train_step` installs) `params` are this rank's
    blocks, `batch` its block of the batch axes, the residual stream its
    sequence block until the final norm, after which the sequence is
    gathered over `model`; the loss is the sum of the ranks' shares, and
    it and its metrics are the whole batch's on every rank (the aux the
    reference's: the rank at mesh coordinate 0's)."""
    split = split_mesh()
    x, prefix_len = _inputs_to_x(params, batch, cfg)
    x, _, aux = apply_stack(params["stack"], x, cfg, prefix_len=prefix_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps).to(torch.bfloat16)
    if split is not None:
        x = all_gather(x, split, "model", 1)
    if cfg.is_encoder:
        targets = batch["targets"]
        mask = batch.get("loss_mask")
        mask = (torch.ones(targets.shape, device=x.device) if mask is None
                else mask.float())
    else:
        tokens = batch["tokens"]
        if cfg.input_mode == "prefix_vlm":
            x = x[:, prefix_len:]         # loss over the text positions only
        targets, x = tokens[:, 1:], x[:, :-1]
        mask = batch.get("loss_mask")
        mask = (torch.ones(targets.shape, device=x.device) if mask is None
                else mask[:, 1:].float())
    ce, cnt = _chunked_ce(params, x, targets, mask, cfg)
    if split is not None and any(cfg.layer_is_moe):
        # the MoE layers' aux shares (`nn.moe._aux_share`) summed over the
        # ranks: the origin rank's aux, on every rank
        aux = psum(aux, split, split.axis_names)
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "tokens": cnt}


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache_len: int):
    """Run the prompt batch through the model, returning
    (next_token_logits (B, vocab_padded), caches of length cache_len); a
    prefix-VLM prompt's cache holds its P image positions first."""
    logits, caches, _ = forward(params, batch, cfg, make_cache=True,
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
    int8 latent cache).  A hybrid layer caches {"attn", "mamba": {conv
    (..., batch, W - 1, di) in ``dtype``, h (..., batch, di, N) f32}};
    mLSTM layers {S, n} and sLSTM layers {c, n, h}, all f32 and free of
    ``cache_len``."""
    dev = resolve_device(device)
    int8 = cfg.kv_cache_dtype == "int8" and not staging

    def attn_entry(lead, window):
        if cfg.attn_type == "mla":
            return {"c_kv": torch.zeros(lead + (batch, cache_len,
                                                cfg.kv_lora_rank),
                                        dtype=dtype, device=dev),
                    "k_rope": torch.zeros(lead + (batch, cache_len,
                                                  cfg.qk_rope_dim),
                                          dtype=dtype, device=dev)}
        L = min(window, cache_len) if window and not staging else cache_len
        shape = lead + (batch, L, cfg.n_kv_heads, cfg.head_dim)
        kv_dt = torch.int8 if int8 else dtype
        entry = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
                 "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
        if int8:
            entry["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=dev)
            entry["v_scale"] = torch.zeros_like(entry["k_scale"])
        return entry

    caches = []
    for start, length, scanned in stack_plan(cfg):
        kind = layer_kind(cfg, start)
        lead = ((length,) if scanned else ()) + (batch,)
        if kind == "mlstm":
            caches.append(init_mlstm_cache(cfg, lead, dev))
        elif kind == "slstm":
            caches.append(init_slstm_cache(cfg, lead, dev))
        else:
            entry = {"attn": attn_entry(lead[:-1],
                                        cfg.window_for_layer(start))}
            if kind == "hybrid":
                entry["mamba"] = init_mamba_cache(cfg, lead, dtype, dev)
            caches.append(entry)
    return caches


def chunk_prefill(params: Params, tokens: torch.Tensor, caches, start: int,
                  n_valid: int, cfg: ModelConfig):
    """One chunked-prefill step: run ``tokens`` (B, C) at absolute positions
    [start, start+C) against the staging ``caches`` (``init_cache(...,
    staging=True)`` zeros for the first chunk), which are written in place.
    Only the first ``n_valid`` tokens are real; the padded tail writes K/V
    that no later query's mask admits and leaves recurrent state frozen.
    Returns (logits (B, vocab_padded)
    at position start + n_valid - 1, caches) — the last chunk's logits are
    the prompt's next-token distribution, as ``prefill`` returns it."""
    x, _ = _inputs_to_x(params, {"tokens": tokens}, cfg)
    x, _, _ = apply_stack(params["stack"], x, cfg, caches=caches,
                          cache_pos=int(start), valid_len=int(n_valid))
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
    logits, new_caches, _ = forward(params, {"tokens": token[:, None]}, cfg,
                                    caches=caches, cache_pos=pos,
                                    last_only=True, page_table=page_table)
    return logits[:, 0], new_caches
