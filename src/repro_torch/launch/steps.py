"""Step functions and their sharding trees — PyTorch port of
`repro.launch.steps`: the training step, the serving steps, the sharding
trees of params, optimizer state, batches and caches over a device mesh,
and the abstract inputs of every cell as `meta` tensors (shapes and
dtypes, nothing allocated).

The reference wraps each step in a cached `jax.jit`.  PyTorch runs
eagerly, so the steps are plain functions; the prefill steps keep the
reference's `functools.lru_cache`d factories all the same, keyed on the
same shapes, so `prefill_cache_info` counts the distinct prefill shapes
an engine ran exactly as the reference counts its jit traces.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Sequence

import torch

from repro_torch.data.pipeline import DataConfig, make_batch_specs
from repro_torch.nn.attention import _kv_quant
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.model import (chunk_prefill, decode_step, init_cache,
                                  init_params, lm_loss, param_specs, prefill)
from repro_torch.nn.transformer import layer_kind, stack_plan
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine, wsd
from repro_torch.parallel.collectives import all_reduce_
from repro_torch.parallel.sharding import (NamedSharding, PartitionSpec as P,
                                           axis_size, batch_block,
                                           current_mesh, flat_shardings,
                                           local_shape, make_spec,
                                           split_axes, splitting, use_ctx)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


# ----------------------------------------------------------------- train
def make_train_step(cfg: ModelConfig, peak_lr: float = 3e-4,
                    warmup: int = 2000, total: int = 100_000):
    """The reference's `make_train_step`: WSD for the minicpm family
    (stable 80% of `total`, decay 10%), cosine otherwise.  The step
    `(params, opt_state, batch, step) -> (params, opt_state, metrics)`
    takes the loss's gradient in every param leaf (autograd through
    `lm_loss`, each block rematerialized) and applies AdamW in place;
    metrics hold loss, lr, ce, aux, tokens and grad_norm as 0-d
    tensors.

    Under an installed mesh a config that `split_shardings` splits takes
    the split path: `params` and `opt_state` are this rank's blocks
    (`parallel.sharding.place` under `split_shardings`), `batch` the
    global batch, of which the step takes this rank's block of the batch
    axes.  The step installs the path (`parallel.sharding.splitting`) for
    the loss, its gradient and AdamW, which read it through
    `parallel.sharding.split_mesh`.  The gathers' backward reduce-scatters
    each split leaf's gradient over the axes it is split over; each
    gradient is then all-reduced over the mesh axes its leaf is not split
    over (a norm scale over every axis, a matrix over `pod`), which makes
    it the one-process gradient's block, and AdamW updates the blocks
    with the global norm."""
    if cfg.name.startswith("minicpm"):
        sched = functools.partial(wsd, peak_lr=peak_lr, warmup=warmup,
                                  stable=int(total * 0.8),
                                  decay=int(total * 0.1))
    else:
        sched = functools.partial(cosine, peak_lr=peak_lr, warmup=warmup,
                                  total=total)
    whole = []          # the whole leaves' shapes, read once on the split path

    def train_step(params, opt_state: AdamWState, batch, step):
        ctx = current_mesh()
        shardings = (split_shardings(cfg, ctx.mesh) if ctx is not None
                     else None)
        leaves = tree_flatten(params)
        split = None
        if shardings is not None:
            shardings = flat_shardings(shardings["params"])
            if not whole:
                whole.extend(t.shape for t in
                             tree_flatten(abstract_params(cfg)))
            for t, w, sh in zip(leaves, whole, shardings, strict=True):
                if tuple(t.shape) != local_shape(w, sh):
                    raise ValueError(
                        f"a leaf of {tuple(t.shape)} is not this rank's "
                        f"block of {tuple(w)} under {sh.spec}: place the "
                        f"params first (parallel.sharding.place)")
            batch = batch_block(batch, ctx)
            ctx = split = splitting(ctx, [split_axes(sh) for sh in shardings])
        with use_ctx(ctx):
            return _train_update(params, leaves, opt_state, batch,
                                 sched(step), split)

    def _train_update(params, leaves, opt_state, batch, lr, split):
        for t in leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = lm_loss(params, batch, cfg)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        if split is not None:
            for g, split_on in zip(grads, split.leaf_axes):
                for name in split.axis_names:
                    if name not in split_on:
                        all_reduce_(g, split.group(name), axis=name)
        grads = tree_unflatten(params, grads)
        new_params, new_opt, om = adamw_update(params, grads, opt_state, lr)
        out = {"loss": loss.detach(), "lr": lr,
               **{k: v.detach() for k, v in metrics.items()}, **om}
        return new_params, new_opt, out

    return train_step


def prefill_step(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 cache_len: int):
    """A prompt batch ({"tokens": (B, S)}, with "patch_embeds" for a prefix
    VLM) -> (next-token logits (B, vocab_padded), batch caches of length
    cache_len)."""
    return prefill(params, batch, cfg, cache_len)


@functools.lru_cache(maxsize=None)
def cached_prefill_step(cfg: ModelConfig, cache_len: int):
    """`prefill_step` at one cache length: (params, batch) -> (logits,
    caches)."""
    def step(params, batch):
        return prefill_step(params, batch, cfg, cache_len)
    return step


def chunk_prefill_step(params, tokens: torch.Tensor, caches, start: int,
                       n_valid: int, cfg: ModelConfig):
    """One chunk (1, C) at absolute positions [start, start+C) of a staging
    cache (written in place), only the first `n_valid` tokens real ->
    (logits (1, vocab_padded) at start + n_valid - 1, caches)."""
    return chunk_prefill(params, tokens, caches, start, n_valid, cfg)


@functools.lru_cache(maxsize=None)
def cached_chunk_prefill_step(cfg: ModelConfig, chunk_len: int,
                              staging_len: int):
    """`chunk_prefill_step` for chunks of `chunk_len` tokens (the engine pads
    the tail chunk up to a bucket-ladder rung) into a `staging_len` staging
    cache.  Keyed on both, so the number of misses is the number of
    distinct chunk shapes — bounded by the ladder sizes, as the reference's
    jit traces are (see prefill_cache_info)."""
    def step(params, tokens, caches, start, n_valid):
        if tokens.shape[1] != chunk_len:
            raise ValueError(f"chunk of {tokens.shape[1]} tokens through a "
                             f"{chunk_len}-token step")
        return chunk_prefill_step(params, tokens, caches, start, n_valid,
                                  cfg)
    return step


def prefill_cache_info() -> Dict[str, int]:
    """Hit/miss/shape counters over the prefill step caches (process-wide,
    shared by every engine instance of the same config), under the
    reference's keys."""
    mono = cached_prefill_step.cache_info()
    chunk = cached_chunk_prefill_step.cache_info()
    return {
        "prefill_hits": mono.hits, "prefill_misses": mono.misses,
        "prefill_traces": mono.currsize,
        "chunk_hits": chunk.hits, "chunk_misses": chunk.misses,
        "chunk_traces": chunk.currsize,
        "hits": mono.hits + chunk.hits,
        "misses": mono.misses + chunk.misses,
        "traces": mono.currsize + chunk.currsize,
    }


# ----------------------------------------- chunked-prefill staging install
def _finalize_attn_entry(cfg: ModelConfig, entry, *, axis: int, window: int,
                         target_len: int, true_len: int,
                         ring_windows: bool):
    """One attention entry from the raw full-length staging layout to the
    serving layout: MLA latents are only sliced (no int8 latent cache, as
    in the reference); int8 GQA tenants quantize here (staging attends in
    bf16, as the monolithic prefill does, and quantizes once); with
    `ring_windows` (slot arenas) a sliding-window layer is gathered down to
    its window-sized ring; every other leaf is sliced to `target_len`.
    Page pools store every position, so their install source is only
    quantized."""
    def shape_to(leaf):
        if ring_windows and 0 < window < target_len:
            # ring slot i holds the largest valid position = i (mod
            # window); slots with no valid position yet gather the clipped
            # position 0, which the decode mask (abs_pos >= 0) never admits
            last = true_len - 1
            idx = last - torch.remainder(
                last - torch.arange(window, device=leaf.device), window)
            idx = torch.clamp(idx, 0, leaf.shape[axis] - 1)
            return torch.index_select(leaf, axis, idx)
        if leaf.shape[axis] > target_len:
            return leaf.narrow(axis, 0, target_len)
        return leaf

    if cfg.attn_type == "mla":
        return {name: shape_to(leaf) for name, leaf in entry.items()}
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _kv_quant(entry["k"])
        vq, vs = _kv_quant(entry["v"])
        return {"k": shape_to(kq), "v": shape_to(vq),
                "k_scale": shape_to(ks), "v_scale": shape_to(vs)}
    return {"k": shape_to(entry["k"]), "v": shape_to(entry["v"])}


def _make_stage_finalize(cfg: ModelConfig, target_len: int,
                         ring_windows: bool):
    plan = stack_plan(cfg)

    def finalize(staging, true_len: int):
        # only attention entries have a length: a pure recurrent segment
        # (mLSTM, sLSTM) passes through, and a hybrid one keeps its Mamba
        # state as it is
        return [{**seg, "attn": _finalize_attn_entry(
                    cfg, seg["attn"], axis=2 if scanned else 1,
                    window=cfg.window_for_layer(start),
                    target_len=target_len, true_len=int(true_len),
                    ring_windows=ring_windows)} if "attn" in seg else seg
                for seg, (start, _, scanned) in zip(staging, plan)]
    return finalize


@functools.lru_cache(maxsize=None)
def cached_stage_install(cfg: ModelConfig, staging_len: int, arena_len: int):
    """Staging -> slot-arena row (the reference's `cached_stage_install`,
    keyed on the same shapes): ring the windowed layers, slice the rest to
    `arena_len`, quantize int8 tenants.  (staging, true_len) -> row."""
    return _make_stage_finalize(cfg, arena_len, ring_windows=True)


@functools.lru_cache(maxsize=None)
def cached_stage_quantize(cfg: ModelConfig, staging_len: int):
    """Staging -> paged-pool install source (the reference's
    `cached_stage_quantize`, keyed on the same shapes): only int8 tenants
    change.  The staging is left as it is; the page writer slices several
    blocks out of the finalized source.  (staging, true_len) -> source."""
    return _make_stage_finalize(cfg, staging_len, ring_windows=False)


@functools.lru_cache(maxsize=None)
def cached_serve_step(cfg: ModelConfig):
    """One decode step over contiguous caches, the slot layout, for one
    config: (params, token, caches, pos) -> (logits (B, vocab_padded),
    caches), the caches written in place; `pos` may be a scalar or a
    per-row (B,) vector — the vector form is what slot-based continuous
    batching decodes with."""
    return functools.partial(decode_step, cfg=cfg)


def paged_serve_step(params, token, caches, pos, page_table,
                     cfg: ModelConfig):
    """(`cached_paged_serve_step`) one decode step over a paged KV arena:
    caches are page pools (written in place), pos the per-row (B,) write
    positions, page_table (B, T) each row's block -> page map.  Returns
    (logits (B, vocab_padded), caches)."""
    return decode_step(params, token, caches, pos, cfg, page_table)


def fused_paged_serve_step(params, token, caches, pos, page_table,
                           temps: Sequence[float], top_ks: Sequence[int],
                           keys: Sequence, steps: Sequence[int],
                           cfg: ModelConfig):
    """(`cached_fused_paged_serve_step`) paged decode step with sampling
    fused in: the logits stay on the device and only the (B,) int32 token
    ids come back.  Sampler controls as in `sample_tokens`."""
    from repro_torch.serving.sampling import sample_tokens
    logits, caches = decode_step(params, token, caches, pos, cfg, page_table)
    toks = sample_tokens(logits, cfg.vocab, temperatures=temps,
                         top_ks=top_ks, keys=keys, steps=steps)
    return toks, caches


def sample_step(logits, vocab: int, temps: Sequence[float],
                top_ks: Sequence[int], keys: Sequence,
                steps: Sequence[int]) -> torch.Tensor:
    """(`cached_sample_tokens`) batched sampler for the split path: one
    call per decode batch, never one host sync per row."""
    from repro_torch.serving.sampling import sample_tokens
    return sample_tokens(logits, vocab, temperatures=temps, top_ks=top_ks,
                         keys=keys, steps=steps)


# ------------------------------------------------------------- shardings
def _is_spec_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def param_shardings(cfg: ModelConfig, mesh):
    return tree_map(lambda s: NamedSharding(mesh, make_spec(*s)),
                    param_specs(cfg), is_leaf=_is_spec_leaf)


def split_shardings(cfg: ModelConfig, mesh):
    """{"params", "opt"}: the shardings `make_train_step` takes its state
    in under `mesh` when it splits `cfg`'s layers over it, else None.
    The one place that picks the split path: the dense GQA families
    (gemma-7b, minicpm-2b, qwen3-32b, yi-34b) and the MoE families
    (deepseek-v2-lite-16b with MLA attention, qwen3-moe-235b-a22b with
    GQA) split; the recurrent and input-mode families keep their layers
    whole on every rank.  `launch.train` places its state and the dry
    run counts a split step by it."""
    if cfg.family not in ("dense", "moe"):
        return None
    psh = param_shardings(cfg, mesh)
    return {"params": psh, "opt": opt_shardings(psh, mesh)}


def opt_shardings(param_sh, mesh):
    return AdamWState(step=NamedSharding(mesh, P()), mu=param_sh,
                      nu=param_sh)


def batch_shardings(cfg: ModelConfig, mesh):
    ba = make_spec("batch")[0]
    out: Dict[str, NamedSharding] = {}
    d = DataConfig(seq_len=8, global_batch=8)  # structure only
    for k in make_batch_specs(cfg, d):
        if k in ("tokens", "targets", "loss_mask"):
            out[k] = NamedSharding(mesh, P(ba, None))
        else:  # embeds / patch_embeds: shard seq over model too
            out[k] = NamedSharding(mesh, P(ba, "model", None))
    return out


def batch_axis_for(mesh, global_batch: int):
    """The batch mesh axes, or None (replicate) when the batch is too small
    to shard (e.g. long_500k's single sequence)."""
    ba = make_spec("batch")[0]
    if ba is None:
        return None
    axes = (ba,) if isinstance(ba, str) else tuple(ba)
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return ba if global_batch % n == 0 else None


def cache_shardings(cfg: ModelConfig, mesh, global_batch: int = 0):
    """Mirrors nn.model.init_cache structure (segment plan)."""
    ba = make_spec("batch")[0]
    if global_batch:
        ba = batch_axis_for(mesh, global_batch)

    def rep(*s):
        return NamedSharding(mesh, P(*s))

    def entry(window):
        if cfg.attn_type == "mla":
            return {"c_kv": rep(ba, "model", None),
                    "k_rope": rep(ba, "model", None)}
        out = {"k": rep(ba, "model", None, None),
               "v": rep(ba, "model", None, None)}
        if cfg.kv_cache_dtype == "int8":
            out["k_scale"] = rep(ba, "model", None)
            out["v_scale"] = rep(ba, "model", None)
        return out

    def layer_spec(i: int):
        kind = layer_kind(cfg, i)
        if kind == "mlstm":
            return {"S": rep(ba, None, None, None), "n": rep(ba, None, None)}
        if kind == "slstm":
            return {"c": rep(ba, None, None), "n": rep(ba, None, None),
                    "h": rep(ba, None, None)}
        if kind == "hybrid":
            return {
                "attn": entry(cfg.window_for_layer(i)),
                "mamba": {"conv": rep(ba, None, "model"),
                          "h": rep(ba, "model", None)},
            }
        return {"attn": entry(cfg.window_for_layer(i))}

    out = []
    for start, length, scanned in stack_plan(cfg):
        one = layer_spec(start)
        if scanned:
            one = tree_map(lambda sh: NamedSharding(mesh, P(None, *sh.spec)),
                           one)
        out.append(one)
    return out


# ------------------------------------------------------- abstract inputs
META = torch.device("meta")


def _bf16_floats(tree):
    return tree_map(lambda t: t.to(torch.bfloat16)
                    if t.is_floating_point() else t, tree)


def abstract_params(cfg: ModelConfig):
    """`init_params`' tree on the `meta` device with every float leaf in
    bf16, as the reference's `eval_shape` stand-ins are."""
    return _bf16_floats(init_params(cfg, device=META))


def abstract_opt_state(aparams):
    return adamw_init(aparams)


def abstract_caches(cfg: ModelConfig, batch: int, cache_len: int):
    return init_cache(cfg, batch, cache_len, device=META)


def input_specs(cfg: ModelConfig, shape_kind: str, seq_len: int,
                global_batch: int) -> Dict[str, Any]:
    """`meta` tensor stand-ins for every model input of a cell."""
    data = DataConfig(seq_len=seq_len, global_batch=global_batch)
    if shape_kind == "train":
        return {
            "params": abstract_params(cfg),
            "opt_state": None,  # filled by caller
            "batch": make_batch_specs(cfg, data),
            "step": torch.empty((), dtype=torch.int32, device=META),
        }
    if shape_kind == "prefill":
        return {
            "params": abstract_params(cfg),
            "batch": make_batch_specs(cfg, data),
        }
    # decode: one token, cache of seq_len
    return {
        "params": abstract_params(cfg),
        "token": torch.empty((global_batch,), dtype=torch.int32,
                             device=META),
        "caches": abstract_caches(cfg, global_batch, seq_len),
        "pos": torch.empty((), dtype=torch.int32, device=META),
    }
