"""Block assembly and the layer stack — PyTorch port of
`repro.nn.transformer`: attention blocks (dense or MoE), hymba's hybrid
blocks (SWA or global attention beside Mamba) and xLSTM's mLSTM / sLSTM
blocks.

The reference scans homogeneous runs of layers over stacked parameters;
the port keeps that stacked layout (so weights and caches carry over leaf
for leaf) and runs each scanned segment as a Python loop over its layers.

The residual stream is carried as the compiled reference carries it.
Each residual add sums bf16-rounded operands in f32, and XLA keeps that
sum unrounded on its way into the next RMSNorm (the add fuses with the
norm's f32 upcast) while the next add reads it rounded to bf16.  Across a
scanned segment's layers the carry is a bf16 array, so there the stream
is rounded at every layer boundary.  Following the same rounding points
keeps the port's bf16 activations bit-equal to the reference's on the
CPU, which is what makes greedy tokens identical near ties.

Training rematerializes every block, as the reference's `jax.checkpoint`
does: with `cfg.remat`, no cache, no `make_cache` and autograd on, each
block runs inside `torch.utils.checkpoint`, which saves only the block's
input and runs the block again in the backward pass, under the mesh the
forward ran under (autograd runs a CUDA backward on a thread of its own,
where the thread-local mesh is not installed).

On the split path (`launch.steps.split_shardings`: the dense GQA and
the MoE families) the stream between blocks is this rank's ("batch",
"sp", None) block and RMSNorm runs on it; attention and the MLP gather
and scatter the sequence themselves, and the MoE layer routes the block
as it is.  The recomputation runs under the same split mesh, so every
rank issues the forward's collectives in the same order again (torch's
checkpoint stops it after the last tensor the backward needs, on every
rank alike: a block's closing reduce-scatter is not re-issued).  The
MoE layer's all-to-alls depend on no value, only on shapes, so the
recomputation issues them on every rank alike too.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.attention import attention, attention_specs
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import mlp, mlp_specs, rmsnorm, rmsnorm_specs
from repro_torch.nn.moe import moe, moe_specs
from repro_torch.nn.ssm import (mamba, mamba_specs, mlstm, mlstm_specs, slstm,
                                slstm_specs)
from repro_torch.parallel.sharding import current_mesh, use_ctx
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def layer_kind(cfg: ModelConfig, i: int) -> str:
    if cfg.family == "ssm":
        if cfg.slstm_every and (i % cfg.slstm_every == cfg.slstm_every - 1):
            return "slstm"
        return "mlstm"
    if cfg.hybrid_parallel:
        return "hybrid"
    return "attn"


def _block_signature(cfg: ModelConfig, i: int):
    """Layers with equal signatures share block structure (and stack)."""
    return (layer_kind(cfg, i), cfg.window_for_layer(i), cfg.layer_is_moe[i])


def stack_plan(cfg: ModelConfig, min_group: int = 4) -> List[Tuple[int, int, bool]]:
    """Partition layers into (start, length, scanned) segments: maximal runs
    of identical signatures become stacked groups, singletons/short runs
    stand alone — the reference's plan, so the param trees line up."""
    if not cfg.scan_layers:
        min_group = max(min_group, 10**9)
    segs: List[Tuple[int, int, bool]] = []
    i = 0
    while i < cfg.n_layers:
        j = i
        sig = _block_signature(cfg, i)
        while j < cfg.n_layers and _block_signature(cfg, j) == sig:
            j += 1
        run = j - i
        if run >= min_group:
            segs.append((i, run, True))
        else:
            segs.extend((k, 1, False) for k in range(i, j))
        i = j
    return segs


def block_specs(cfg: ModelConfig, i: int) -> Params:
    kind = layer_kind(cfg, i)
    s: Params = {"norm1": rmsnorm_specs()}
    if kind == "mlstm":
        s["cell"] = mlstm_specs(cfg)
        return s
    if kind == "slstm":
        s["cell"] = slstm_specs(cfg)
        return s
    s["attn"] = attention_specs(cfg)
    if kind == "hybrid":
        s["mamba"] = mamba_specs(cfg)
    s["norm2"] = rmsnorm_specs()
    if cfg.layer_is_moe[i]:
        s["moe"] = moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg.gated)
    return s


def stack_specs(cfg: ModelConfig) -> Params:
    """The stack's spec tree: a stacked segment's specs gain a leading
    None (its layer axis is never split)."""
    segments = []
    for start, length, scanned in stack_plan(cfg):
        base = block_specs(cfg, start)
        if scanned:
            base = tree_map(lambda spec: (None,) + tuple(spec), base,
                            is_leaf=lambda x: isinstance(x, tuple))
        segments.append(base)
    return {"segments": segments}


def apply_block(bp: Params, x: torch.Tensor, cfg: ModelConfig, i: int, *,
                prefix_len: int = 0, cache: Optional[Params] = None,
                cache_pos=None, make_cache: bool = False, cache_len: int = 0,
                page_table=None, valid_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """One pre-norm block over the residual stream `x` (bf16, or the f32
    unrounded sum a previous block returned), by `layer_kind`:

      * attn: attention + gated MLP (or MoE);
      * hybrid (hymba): attention and Mamba side by side on the same
        normed input, their outputs averaged in bf16, then the MLP;
      * mlstm / slstm (xLSTM): `x + cell(norm1(x))`, no MLP.

    `prefix_len` is the count of leading positions every query of a
    causal prefill sees (a prefix-VLM's image patches).  `valid_len`
    marks how many of a chunk's tokens are real: recurrent layers freeze
    their state past it (attention masks make it irrelevant
    there).  Returns (the f32 unrounded residual sum, new_cache, the MoE
    router's aux loss (f32; 0 on other blocks))."""
    kind = layer_kind(cfg, i)
    act = torch.bfloat16
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps).to(act)
    if kind in ("mlstm", "slstm"):
        cell = mlstm if kind == "mlstm" else slstm
        y, new_cache = cell(bp["cell"], h, cfg, cache=cache,
                            make_cache=make_cache, valid_len=valid_len)
        return (x.to(act).float() + y.float(), new_cache,
                torch.zeros((), device=x.device))
    y, new_attn = attention(
        bp["attn"], h, cfg, layer_window=cfg.window_for_layer(i),
        prefix_len=prefix_len, cache=cache.get("attn") if cache else None,
        cache_pos=cache_pos, make_cache=make_cache, cache_len=cache_len,
        page_table=page_table)
    new_cache = {"attn": new_attn} if new_attn is not None else None
    if kind == "hybrid":
        y_ssm, new_mamba = mamba(bp["mamba"], h, cfg,
                                 cache=cache.get("mamba") if cache else None,
                                 make_cache=make_cache, valid_len=valid_len)
        y = 0.5 * (y + y_ssm)           # the mean of the two branches, bf16
        if new_attn is not None or new_mamba is not None:
            new_cache = {"attn": new_attn, "mamba": new_mamba}
    mid = x.to(act).float() + y.float()
    h2 = rmsnorm(bp["norm2"], mid, cfg.norm_eps).to(act)
    if "moe" in bp:
        # multi-token chunked prefill takes the batch routing path (same
        # numerics as the monolithic prefill); only true one-token steps
        # use the replicated-token decode strategy
        y2, aux = moe(bp["moe"], h2, cfg,
                      decode=(cache is not None and x.shape[1] == 1))
    else:
        y2, aux = mlp(bp["mlp"], h2, cfg.act), torch.zeros((), device=x.device)
    out = mid.to(act).float() + y2.float()
    return out, new_cache, aux


def _block_under(ctx, *args, **kw):
    """`apply_block` under the mesh `ctx` (a rematerialized block)."""
    with use_ctx(ctx):
        return apply_block(*args, **kw)


def _unstack(tree: Params) -> List[Params]:
    """A stacked segment's params as one tree per layer, by one `unbind`
    per (L, ...) leaf: under autograd its backward stacks the L layers'
    gradients once, where indexing each layer would add L full-size
    (L, ...) gradients into the leaf."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        return [{k: per[k][li] for k in tree}
                for li in range(len(next(iter(per.values()))))]
    return list(tree.unbind(0))


def apply_stack(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                prefix_len: int = 0, caches: Optional[List[Any]] = None,
                cache_pos=None, make_cache: bool = False, cache_len: int = 0,
                page_table=None, valid_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[List[Any]], torch.Tensor]:
    """Run every segment of `stack_plan(cfg)`.  Stacked segments index
    their (L, ...) params and caches per layer; a new stacked cache from a
    prefill is stacked back to (L, ...) leaves.  Returns the residual
    stream (f32 unrounded after a single block, bf16 after a stacked
    segment), the caches and the blocks' summed aux loss."""
    new_caches: List[Any] = []
    aux_total = torch.zeros((), device=x.device)
    remat = (cfg.remat and caches is None and not make_cache
             and torch.is_grad_enabled())
    mesh = current_mesh()

    def block(bp, x, i, cache, kw):
        if remat:
            return checkpoint(_block_under, mesh, bp, x, cfg, i, cache=None,
                              use_reentrant=False, **kw)
        return apply_block(bp, x, cfg, i, cache=cache, **kw)

    for seg_idx, (start, length, scanned) in enumerate(stack_plan(cfg)):
        seg_params = params["segments"][seg_idx]
        seg_cache = caches[seg_idx] if caches is not None else None
        kw = dict(prefix_len=prefix_len, cache_pos=cache_pos,
                  make_cache=make_cache, cache_len=cache_len,
                  page_table=page_table, valid_len=valid_len)
        if not scanned:
            x, nc, aux = block(seg_params, x, start, seg_cache, kw)
            aux_total = aux_total + aux
            new_caches.append(nc)
            continue
        layer_caches = []
        layers = _unstack(seg_params)
        for li in range(length):
            bp = layers[li]
            lc = (tree_map(lambda a, li=li: a[li], seg_cache)
                  if seg_cache is not None else None)
            x, nc, aux = block(bp, x, start, lc, kw)
            x = x.to(torch.bfloat16)        # the scan carry is bf16
            aux_total = aux_total + aux
            layer_caches.append(nc)
        if seg_cache is not None:
            new_caches.append(seg_cache)    # pools were written in place
        elif make_cache:
            new_caches.append(tree_map(lambda *ls: torch.stack(ls),
                                       *layer_caches))
        else:
            new_caches.append(None)
    if all(c is None for c in new_caches):
        return x, None, aux_total
    return x, new_caches, aux_total
