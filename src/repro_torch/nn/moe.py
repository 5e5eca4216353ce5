"""Mixture-of-Experts with expert parallelism — PyTorch port of
`repro.nn.moe`.

Without an installed mesh the reference runs its dense single-device
oracle `moe_reference`: route every token in f32 (softmax, top-k, the k
gates normalized by their sum), evaluate every expert on every token in
bf16, accumulate the gated expert outputs (kept in f32, see `_down_f32`)
in f32 in expert order, cast the sum once to bf16 and add the shared
experts' gated MLP.  It is exact: no capacity, no dropped token.
`moe_reference` keeps the reference's loop over the experts.  `moe`, what
the blocks call, computes the same function with the experts stacked: one
batched product per weight over every expert, in token chunks that bound
the (E, tokens, d) activations, and the expert-order f32 sum as a
`cumsum` over the expert axis (a sequential scan on either device, so the
sum associates as the reference's loop does).  No host sync and no shape
that depends on the routing, so a decode step stays one fixed sequence of
launches.

Under an installed mesh (`parallel.sharding.use_mesh`) `moe` runs the
reference's `shard_map` bodies on every rank of a `torch.distributed`
device mesh.  Experts are split over the `model` axis; within each expert
the weights are FSDP-split over `data` and all-gathered per layer.  The
collectives run over the mesh's axis groups (autograd Functions over
`torch.distributed` calls, so a training step differentiates through
them):
  * all-to-all (train / prefill, `_moe_body_a2a`): tokens split over the
    batch axes and, by sequence, over `model`; each rank routes its tokens
    and packs per-expert capacity buffers (`_pack_dispatch`, a capacity
    factor with drops), exchanges them with one `all_to_all_single`, runs
    its local experts on E_loc·M·cap rows and sends the results back;
  * replicated tokens (decode, `_moe_body_replicated`): tokens replicated
    over `model`; each rank evaluates only its local experts, masked by
    the routing, and the partial outputs are summed by `all_reduce`.

Two layouts call the bodies:

  * the split path (training, `launch.steps.split_shardings`, read
    through `parallel.sharding.split_mesh`): `x` is the rank's
    (B_l, S / model, D) block of the sequence-split residual stream,
    exactly the reference's `in_specs P(ba, "model", None)`, and the
    expert stacks are the rank's placed blocks; the all-to-all body runs
    on them as they are and the output stays the rank's block.  The
    shared experts take the dense split (`nn.layers.mlp`).  The router
    is a whole leaf: each rank's gradient of it is its tokens' share,
    which the step all-reduces over the mesh.  The loss is the sum of
    the ranks' shares, and the aux loss enters it as `_aux_share` hands
    it over: the value of the rank at mesh coordinate 0 (the reference's
    `out_specs P()`), counted once, with the reference's gradient, the
    mean of the ranks' own aux gradients (its transpose divides the
    replicated output's cotangent by the mesh size);
  * the whole-tensor path (prefill and decode under a mesh):
    every rank holds the whole (B, S, D) input and the whole stacks,
    takes its block of each by its mesh coordinates, and gathers the
    output back to the global (B, S, D) on every rank.  The shared
    experts' MLP runs on the rank's own token block (on the replicated
    path, model rank 0's output is the one autograd follows).  Every
    rank computes the same loss, so the input and the parameters enter
    through `_Replicated`, whose backward sums the rank's share over the
    whole mesh, and each rank ends with the one-process gradient.  The
    aux loss is the value of the rank at mesh coordinate 0 (on the
    replicated path after its mean over `model`), which every rank
    receives.

The collectives are `repro_torch.parallel.collectives`' Functions; under
its `recording_collectives()` they leave a record each for the dry run's
collective term (`repro_torch.launch.dryrun`): the exchanges and gathers,
forward and backward, and `_Psum`'s all-reduce.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import _act, mlp, mlp_specs
from repro_torch.parallel.collectives import (  # noqa: F401
    _AllToAll, _GatherBlocks, _Owned, _Psum, _Replicated, all_gather,
    recording_collectives)
from repro_torch.parallel.sharding import (MeshCtx, batch_axes, current_mesh,
                                           split_mesh)

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


def moe_specs(cfg: ModelConfig) -> Params:
    s = {
        "router": (None, None),
        "w_gate": ("tp", "fsdp", None),
        "w_up": ("tp", "fsdp", None),
        "w_down": ("tp", None, "fsdp"),
    }
    if cfg.n_shared_experts:
        s["shared"] = mlp_specs(gated=True)
    return s


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


# ----------------------------------------------------------- sharded paths
def _pack_dispatch(xf, gate_vals, gate_idx, n_experts: int, capacity: int):
    """The reference's sort-free capacity dispatch.  Each (token, pick)
    assignment is ranked within its expert by arrival (a cumulative sum
    over the one-hot picks) and kept while its rank is below `capacity`.
    Returns (buffer (E, C, D) with each kept token's row at slot e·C + rank,
    the assignments' token ids (T·k,), their slots (-1 where dropped) and
    their gates (0 where dropped))."""
    T, D = xf.shape
    k = gate_idx.shape[-1]
    flat_expert = gate_idx.reshape(-1)
    flat_token = torch.arange(T, device=xf.device).repeat_interleave(k)
    flat_gate = gate_vals.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_expert.long(), n_experts)
    pos = (torch.cumsum(onehot, dim=0) - 1) * onehot
    pos_in_expert = pos.sum(-1)
    keep = pos_in_expert < capacity
    slot = torch.where(keep, flat_expert * capacity + pos_in_expert,
                       torch.full_like(pos_in_expert, -1))
    # a dropped assignment writes the spare row past the buffer, which is
    # cut off (the reference's out-of-range rows with mode="drop")
    rows = torch.where(keep, slot, n_experts * capacity)
    buf = xf.new_zeros((n_experts * capacity + 1, D))
    buf = buf.index_put((rows,), xf[flat_token])[:-1]
    return (buf.reshape(n_experts, capacity, D), flat_token, slot,
            torch.where(keep, flat_gate, torch.zeros_like(flat_gate)))


def _gathered_weights(w_gate, w_up, w_down, ctx: MeshCtx):
    """FSDP: the weights arrive split over `data` on D (or F); gather."""
    return (all_gather(w_gate, ctx, "data", 1),
            all_gather(w_up, ctx, "data", 1),
            all_gather(w_down, ctx, "data", 2))


def _moe_body_a2a(xb, router, w_gate, w_up, w_down, cfg: ModelConfig,
                  model_size: int, ctx: MeshCtx):
    """Per-rank body (tokens sequence-split over 'model')."""
    Bl, Sl, D = xb.shape
    xf = xb.reshape(-1, D)
    T = xf.shape[0]
    k = cfg.moe_topk
    probs, gate_vals, gate_idx = _route(xf.float(), router.float(), k)
    aux = _aux_loss(probs, gate_idx, cfg.n_experts)
    cap = max(int(T * k * cfg.capacity_factor / cfg.n_experts), 4)
    buf, tok_idx, slot, gate = _pack_dispatch(xf, gate_vals, gate_idx,
                                              cfg.n_experts, cap)
    e_loc = cfg.n_experts // model_size
    model = ctx.group("model")
    # (E, C, D) -> (M, E_loc, C, D) -> exchange -> (M, E_loc, C, D)
    # source-major
    recv = _AllToAll.apply(buf.reshape(model_size, e_loc, cap, D), model,
                           "model")
    toks = recv.transpose(0, 1).reshape(e_loc, model_size * cap, D)
    w_gate, w_up, w_down = _gathered_weights(w_gate, w_up, w_down, ctx)
    y = _expert_ffn(w_gate.to(xb.dtype), w_up.to(xb.dtype),
                    w_down.to(xb.dtype), toks, cfg.act).to(xb.dtype)
    y = y.reshape(e_loc, model_size, cap, D).transpose(0, 1)
    back = _AllToAll.apply(y, model, "model").reshape(cfg.n_experts * cap,
                                                      D)
    gathered = back[torch.clamp(slot, 0, cfg.n_experts * cap - 1)]
    contrib = (gathered.float() * gate[:, None]).reshape(T, k, D)
    # each token's k contributions sum in pick order (the scatter-add's
    # order: its slots are consecutive)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out.to(xb.dtype).reshape(Bl, Sl, D), aux


def _moe_body_replicated(xb, router, w_gate, w_up, w_down, cfg: ModelConfig,
                         model_size: int, model_idx: int, ctx: MeshCtx):
    """Per-rank body (tokens replicated over 'model'; decode path)."""
    Bl, Sl, D = xb.shape
    xf = xb.reshape(-1, D)
    probs, gate_vals, gate_idx = _route(xf.float(), router.float(),
                                        cfg.moe_topk)
    aux = _aux_loss(probs, gate_idx, cfg.n_experts)
    e_loc = cfg.n_experts // model_size
    w_gate, w_up, w_down = _gathered_weights(w_gate, w_up, w_down, ctx)
    # every local expert on every token, weighted by the routing gates
    y = _expert_ffn(w_gate.to(xb.dtype), w_up.to(xb.dtype),
                    w_down.to(xb.dtype), xf, cfg.act)     # (E_loc, T, D)
    local_ids = model_idx * e_loc + torch.arange(e_loc, device=xf.device)
    gates = torch.sum(gate_vals[None]
                      * (gate_idx[None] == local_ids[:, None, None]), -1)
    out = torch.einsum("et,etd->td", gates.float(), y.float())
    model = ctx.group("model")
    out = _Psum.apply(out, model)
    aux = _Psum.apply(aux, model) / model_size
    return out.to(xb.dtype).reshape(Bl, Sl, D), aux


def _batch_block(ctx: MeshCtx):
    """(this rank's block index, the block count) along the batch axes."""
    idx, n = 0, 1
    for name in _batch_names():
        size = ctx.size(name)
        idx, n = idx * size + ctx.index(name), n * size
    return idx, n


def _batch_names():
    ba = batch_axes()
    return (ba,) if isinstance(ba, str) else tuple(ba)


def _split(t: torch.Tensor, dim: int, idx: int, n: int) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n} mesh blocks")
    size = t.shape[dim] // n
    return t.narrow(dim, idx * size, size)


def _expert_block(w: torch.Tensor, ctx: MeshCtx,
                  fsdp_axis: int) -> torch.Tensor:
    """This rank's block of an (E, ., .) expert stack: its experts over
    'model' and its FSDP shard over 'data' on `fsdp_axis`."""
    w = _split(w, 0, ctx.index("model"), ctx.size("model"))
    return _split(w, fsdp_axis, ctx.index("data"), ctx.size("data"))


def _gather_blocks(y: torch.Tensor, ctx: MeshCtx, seq: bool) -> torch.Tensor:
    """Every rank's output block back to the global (B, S, D): over
    'model' along the sequence (a2a path), then over the batch axes,
    innermost first."""
    if seq:
        y = _GatherBlocks.apply(y, ctx.group("model"), 1)
    for name in reversed(_batch_names()):
        y = _GatherBlocks.apply(y, ctx.group(name), 0)
    return y


def _from_origin(aux: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """The aux loss of the rank at mesh coordinate 0, on every rank: each
    rank zeroes its own unless it is that rank, and the sums run over
    every mesh axis."""
    origin = all(ctx.index(name) == 0 for name in ctx.axis_names)
    aux = aux * float(origin)
    for name in ctx.axis_names:
        aux = _Psum.apply(aux, ctx.group(name))
    return aux


def _moe_stacked(params: Params, x: torch.Tensor, cfg: ModelConfig
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


def _aux_share(aux: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """This rank's share of the aux loss in a loss summed over the ranks:
    the origin rank's aux as its value (0 on every other rank), and as its
    gradient 1 / (mesh size) of the rank's own aux's."""
    own = aux / math.prod(ctx.size(name) for name in ctx.axis_names)
    origin = all(ctx.index(name) == 0 for name in ctx.axis_names)
    return own + (aux * float(origin) - own).detach()


def _moe_split(params: Params, x: torch.Tensor, cfg: ModelConfig,
               ctx: MeshCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split path (see the module docstring): x and y this rank's
    (B_l, S / model, D) block, the aux its share."""
    y, aux = _moe_body_a2a(x, params["router"], params["w_gate"],
                           params["w_up"], params["w_down"], cfg,
                           ctx.size("model"), ctx)
    if "shared" in params:
        y = y + mlp(params["shared"], x, cfg.act)
    return y, _aux_share(aux, ctx)


def moe(params: Params, x: torch.Tensor, cfg: ModelConfig,
        decode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux).  Without a mesh: the stacked
    form of `moe_reference`.  On the split path: the all-to-all body on
    this rank's blocks.  Under a mesh otherwise: the replicated-token body
    for `decode` or one-token inputs, else the all-to-all body (see the
    module docstring)."""
    split = split_mesh()
    if split is not None:
        return _moe_split(params, x, cfg, split)
    ctx = current_mesh()
    if ctx is None:
        return _moe_stacked(params, x, cfg)
    x = _Replicated.apply(x, ctx)
    params = {k: ({n: _Replicated.apply(w, ctx) for n, w in v.items()}
                  if isinstance(v, dict) else _Replicated.apply(v, ctx))
              for k, v in params.items()}
    model_size = ctx.size("model")
    model_idx = ctx.index("model")
    replicated = decode or x.shape[1] == 1
    b_idx, n_b = _batch_block(ctx)
    xb = _split(x, 0, b_idx, n_b)
    if not replicated:
        xb = _split(xb, 1, model_idx, model_size)
    wg = _expert_block(params["w_gate"], ctx, 1)
    wu = _expert_block(params["w_up"], ctx, 1)
    wd = _expert_block(params["w_down"], ctx, 2)
    if replicated:
        y, aux = _moe_body_replicated(xb, params["router"], wg, wu, wd, cfg,
                                      model_size, model_idx, ctx)
    else:
        y, aux = _moe_body_a2a(xb, params["router"], wg, wu, wd, cfg,
                               model_size, ctx)
    if "shared" in params:
        shared = mlp(params["shared"], xb, cfg.act)
        if replicated:
            # the block is every model rank's; only model rank 0's copy
            # carries a gradient, so the ranks' shares add up once
            shared = _Owned.apply(shared, model_idx == 0)
        y = y + shared
    y = _gather_blocks(y, ctx, seq=not replicated)
    aux = _from_origin(aux, ctx)
    return y, aux
