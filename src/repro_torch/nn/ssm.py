"""Recurrent blocks — PyTorch port of the forward half of `repro.nn.ssm`:
Mamba's selective scan (hymba's SSM branch) and xLSTM's mLSTM and sLSTM.

The reference scans in sequence chunks with the chunk interiors
rematerialized for the backward pass (`chunked_scan`).  Under autograd
(training) the port does the same: Mamba's scan and sLSTM's loop run each
CHUNK of steps inside `torch.utils.checkpoint`, so only the boundary
states are saved, and Mamba's step is out of place (autograd refuses the
serving loop's in-place one) with the same operations in the same order,
so both routes give the same values.  Serving keeps the in-place loop.
The mLSTM's chunkwise form differentiates as it is.  The prefill pads the
sequence to a multiple of the chunk:

  * a padded Mamba step is an exact identity (dt = 0 gives dA = 1 and
    dBx = 0), so the port runs only the real steps; a chunk continuation
    with `valid_len` freezes dt past the valid tokens, as the reference
    does, and the frozen steps are skipped too;
  * the chunkwise-parallel mLSTM is not chunking-invariant (each chunk
    groups its sums by itself), so the port pads to the reference's chunk
    of 256 and groups its chunks the same way;
  * sLSTM's hidden-to-hidden recurrence has no identity step: the
    reference skips a padded step with its `keep` flag, and the port runs
    only the kept steps.

Numerics follow the reference's rounding points: every projection runs
in the bf16 activation dtype and rounds there, also those the reference
casts to f32 next (`dt`, the mLSTM gates, the sLSTM pre-activations); the
recurrent states, gates and decays are f32; elementwise bf16 products
round op by op (`nn.layers._silu`).  Recurrent states in a cache passed
in (slot decode, a chunk continuation) are updated in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import _silu, rmsnorm

Params = Dict[str, Any]

# the reference's scan chunks: Mamba's and mLSTM's (mLSTM's grouping sets
# its rounding; Mamba's bounds the port's per-block scratch)
CHUNK = 256


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A projection the reference computes in bf16 and then casts to f32
    (`dt`, the mLSTM gates, the sLSTM pre-activations): the product is
    rounded to bf16 first."""
    return torch.matmul(x, w.to(x.dtype)).float()


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, `logaddexp(x, 0)`: max(x, 0) + log1p(exp(-|x|))
    (no threshold, unlike `F.softplus`)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def _bf16_const(value: float) -> float:
    """A python scalar as a bf16 operand sees it (jax's weak typing rounds
    it to the array's dtype first)."""
    return torch.tensor(value).to(torch.bfloat16).item()


def _recording(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on these inputs (training)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def chunked_scan(run_chunk, carry, n_steps: int, chunk: int = CHUNK):
    """The reference's `chunked_scan` for the port's loops: steps
    [0, n_steps) in chunks of `chunk`, `run_chunk(carry, s0, s1) ->
    (carry, ys)` for each, every chunk rematerialized in the backward
    pass (only the boundary carries are saved).  Returns (carry, the
    chunks' ys in order)."""
    ys = []
    for s0 in range(0, n_steps, chunk):
        s1 = min(n_steps, s0 + chunk)
        carry, y = checkpoint(run_chunk, carry, s0, s1, use_reentrant=False)
        ys.append(y)
    return carry, ys


def _copy_into(cache: Params, new: Params) -> Params:
    """Write recurrent state `new` into the cache's leaves in place (a
    scanned segment's cache leaves are views of its stacked state)."""
    for name, val in new.items():
        cache[name].copy_(val)
    return cache


# ================================================================== Mamba
def _mamba_conv(x: torch.Tensor, conv_w: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None,
                valid_len: Optional[int] = None):
    """Causal depthwise conv over seq, in x's dtype.  x (B, S, di), conv_w
    (W, di).  Returns (out, the last W - 1 inputs: the window ends at the
    last *valid* token with `valid_len`)."""
    W = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = None
    for i in range(W):           # python's sum: tap by tap, bf16 each add
        term = xp[:, i:i + S] * conv_w[i].to(x.dtype)
        out = term if out is None else out + term
    if W <= 1:
        new_state = None
    elif valid_len is None:
        new_state = xp[:, -(W - 1):]
    else:
        new_state = xp[:, valid_len:valid_len + W - 1]
    return out, new_state


def _mamba_scan(h: torch.Tensor, x_c, dt, Bc, Cc, A, n_steps: int):
    """The selective scan h = exp(dt·A)·h + dt·B·x, y = h·C, in f32 in the
    reference's order, one step at a time over steps [0, n_steps); later
    steps hold h (the reference's frozen tail).  h (B, di, N); x_c, dt
    (B, S, di); Bc, Cc (B, S, N).  Each block of CHUNK steps precomputes
    its dA and dBx at once, so a step is two launches.  Returns
    (y (B, S, di) f32, h after n_steps).  Under autograd the blocks run
    out of place inside `chunked_scan` (`_mamba_scan_grad`)."""
    if _recording(h, x_c, dt, Bc, Cc, A):
        return _mamba_scan_grad(h, x_c, dt, Bc, Cc, A, n_steps)
    S = x_c.shape[1]
    ys = []
    for s0 in range(0, S, CHUNK):
        s1 = min(S, s0 + CHUNK)
        dtb = dt[:, s0:s1].transpose(0, 1)[..., None]          # (K,B,di,1)
        dA = torch.exp(dtb * A)                                 # (K,B,di,N)
        dBx = (dtb * Bc[:, s0:s1].transpose(0, 1)[:, :, None, :]
               * x_c[:, s0:s1].transpose(0, 1)[..., None])
        hs = torch.empty_like(dA)
        n = max(0, min(n_steps, s1) - s0)
        for t in range(n):
            torch.mul(dA[t], h, out=hs[t])
            hs[t].add_(dBx[t])
            h = hs[t]
        if n < s1 - s0:
            hs[n:] = h
        ys.append(torch.einsum("kben,kbn->kbe", hs,
                               Cc[:, s0:s1].transpose(0, 1)))
    return torch.cat(ys).transpose(0, 1), h


def _mamba_scan_grad(h, x_c, dt, Bc, Cc, A, n_steps: int):
    """`_mamba_scan` for training: `h = dA[t]·h + dBx[t]` out of place, the
    serving loop's operations in its order, each CHUNK-step block
    rematerialized; steps from n_steps on hold h."""
    S = x_c.shape[1]

    def block(h, s0, s1):
        dtb = dt[:, s0:s1].transpose(0, 1)[..., None]
        dA = torch.exp(dtb * A)
        dBx = (dtb * Bc[:, s0:s1].transpose(0, 1)[:, :, None, :]
               * x_c[:, s0:s1].transpose(0, 1)[..., None])
        hs = []
        for t in range(max(0, min(n_steps, s1) - s0)):
            h = dA[t] * h + dBx[t]
            hs.append(h)
        hs.extend([h] * (s1 - s0 - len(hs)))
        y = torch.einsum("kben,kbn->kbe", torch.stack(hs),
                         Cc[:, s0:s1].transpose(0, 1))
        return h, y

    h, ys = chunked_scan(block, h, S)
    return torch.cat(ys).transpose(0, 1), h


def mamba_specs(cfg: ModelConfig) -> Params:
    return {
        "w_in": ("fsdp", "tp"), "conv": (None, "tp"),
        "w_xproj": ("tp", None), "w_dt": (None, "tp"), "dt_bias": ("tp",),
        "A_log": ("tp", None), "D": ("tp",), "w_out": ("tp", "fsdp"),
    }


def mlstm_specs(cfg: ModelConfig) -> Params:
    return {
        "w_in": ("fsdp", "tp"), "w_q": ("fsdp", "tp"), "w_k": ("fsdp", "tp"),
        "w_v": ("fsdp", "tp"), "w_if": ("fsdp", None), "if_bias": (None,),
        "norm": {"scale": (None,)}, "w_out": ("tp", "fsdp"),
    }


def slstm_specs(cfg: ModelConfig) -> Params:
    return {"w_gates": ("fsdp", "tp"), "r_gates": (None, None, None),
            "gate_bias": (None,), "norm": {"scale": (None,)},
            "w_out": ("fsdp", "tp")}


def mamba(params: Params, x: torch.Tensor, cfg: ModelConfig,
          cache: Optional[Params] = None, make_cache: bool = False,
          valid_len: Optional[int] = None
          ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B, S, d) bf16.  cache = {conv, h}: with S == 1 a decode step,
    with S > 1 a chunked-prefill continuation in which only the first
    `valid_len` tokens advance the state.  Returns (y (B, S, d), the cache
    written in place, a new one with `make_cache`, or None)."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    dt_rank = params["w_dt"].shape[0]
    chunk_mode = cache is not None and S > 1
    u = torch.matmul(x, params["w_in"].to(x.dtype))
    x_in, z = u[..., :di], u[..., di:]
    x_c, new_conv = _mamba_conv(
        x_in, params["conv"], cache["conv"] if cache is not None else None,
        valid_len=valid_len if chunk_mode else None)
    x_c = _silu(x_c)
    xdbc = torch.matmul(x_c, params["w_xproj"].to(x.dtype))
    dt_in = xdbc[..., :dt_rank]
    Bc = xdbc[..., dt_rank:dt_rank + N].float()
    Cc = xdbc[..., dt_rank + N:].float()
    dt = _softplus(_dot_f32(dt_in, params["w_dt"])
                   + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())                     # (di, N)
    if cache is not None:
        h0 = cache["h"]
    else:
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    n_steps = S if valid_len is None or not chunk_mode else int(valid_len)
    y, hT = _mamba_scan(h0, x_c.float(), dt, Bc, Cc, A, n_steps)
    new_cache = None
    if cache is not None:
        new_cache = _copy_into(cache, {"conv": new_conv, "h": hT})
    elif make_cache:
        new_cache = {"conv": new_conv.contiguous(), "h": hT.clone()}
    y = y.to(x.dtype) + params["D"].to(x.dtype) * x_c
    y = y * _silu(z)
    return torch.matmul(y, params["w_out"].to(x.dtype)), new_cache


# ================================================================== mLSTM
def _mlstm_chunk(q, k, v, log_f, i_gate, S0, n0):
    """One chunk of the chunkwise-parallel mLSTM (the reference's
    `_mlstm_chunk`).  q, k, v (B, H, K, D); log_f, i_gate (B, H, K); S0
    (B, H, D, D); n0 (B, H, D).  Returns (y (B, H, K, D), S1, n1); every
    decay is exp of a difference of the cumulative log-forget, <= 1."""
    c = torch.cumsum(log_f, dim=-1)
    c_last = c[..., -1:]
    ec = torch.exp(c)
    y_inter = torch.einsum("bhkd,bhde->bhke", q, S0) * ec[..., None]
    n_inter = torch.einsum("bhkd,bhd->bhk", q, n0) * ec
    decay = torch.exp(c[..., :, None] - c[..., None, :])
    K = q.shape[2]
    mask = torch.tril(torch.ones((K, K), dtype=torch.bool, device=q.device))
    A = torch.where(mask, decay * i_gate[..., None, :],
                    torch.zeros((), device=q.device))
    scores = torch.einsum("bhkd,bhsd->bhks", q, k) * A
    y_intra = torch.einsum("bhks,bhsd->bhkd", scores, v)
    n_vec = torch.einsum("bhks,bhsd->bhkd", A, k)
    qn = torch.einsum("bhkd,bhkd->bhk", q, n_vec) + n_inter
    denom = torch.clamp_min(torch.abs(qn), 1.0)[..., None]
    y = (y_inter + y_intra) / denom
    w = torch.exp(c_last - c) * i_gate
    e_last = torch.exp(c_last)
    S1 = e_last[..., None] * S0 + torch.einsum("bhkd,bhke->bhde",
                                               w[..., None] * k, v)
    n1 = e_last * n0 + torch.einsum("bhk,bhkd->bhd", w, k)
    return y, S1, n1


def mlstm(params: Params, x: torch.Tensor, cfg: ModelConfig,
          cache: Optional[Params] = None, make_cache: bool = False,
          valid_len: Optional[int] = None
          ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B, S, d) bf16.  cache = {S, n}: with S == 1 a decode step (the
    direct recurrence), with S > 1 a chunk continuation whose gates are
    zeroed past `valid_len` (an identity step).  The prefill pads to
    CHUNK-token chunks, as the reference does."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    H = cfg.ssm_heads
    D = di // H
    dt = x.dtype
    u = torch.matmul(x, params["w_in"].to(dt))
    xm, z = u[..., :di], u[..., di:]
    q = torch.matmul(xm, params["w_q"].to(dt))
    k = torch.matmul(xm, params["w_k"].to(dt)) / _bf16_const(math.sqrt(D))
    v = torch.matmul(xm, params["w_v"].to(dt))
    gates = _dot_f32(xm, params["w_if"]) + params["if_bias"].float()
    i_g = _sigmoid(gates[..., :H]).transpose(1, 2)              # (B,H,S)
    lf = (-_softplus(-gates[..., H:])).transpose(1, 2)          # log_sigmoid

    def heads(t):                                # (B,S,di) -> (B,H,S,D) f32
        return t.reshape(B, S, H, D).transpose(1, 2).float()

    qh, kh, vh = heads(q), heads(k), heads(v)
    if cache is not None and S == 1:
        S0, n0 = cache["S"], cache["n"]
        f1 = torch.exp(lf[..., 0])
        i1 = i_g[..., 0]
        k1, v1, q1 = kh[:, :, 0], vh[:, :, 0], qh[:, :, 0]
        S1 = f1[..., None, None] * S0 + i1[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", k1, v1)
        n1 = f1[..., None] * n0 + i1[..., None] * k1
        qn = torch.einsum("bhd,bhd->bh", q1, n1)
        y = torch.einsum("bhd,bhde->bhe", q1, S1)
        y = (y / torch.clamp_min(torch.abs(qn), 1.0)[..., None])[:, :, None]
        new_cache = _copy_into(cache, {"S": S1, "n": n1})
    else:
        if cache is not None and valid_len is not None:
            keep = (torch.arange(S, device=x.device) < int(valid_len))
            i_g = i_g * keep
            lf = lf * keep
        pad = (-S) % CHUNK
        nch = (S + pad) // CHUNK

        def chunks(t):                   # (B,H,S,...) -> (nch,B,H,CHUNK,...)
            t = torch.nn.functional.pad(
                t, (0, 0) * (t.dim() - 3) + (0, pad))
            return t.reshape(B, H, nch, CHUNK, *t.shape[3:]).movedim(2, 0)

        qc, kc, vc, ic, fc = (chunks(t) for t in (qh, kh, vh, i_g, lf))
        if cache is not None:
            Sst, nst = cache["S"], cache["n"]
        else:
            Sst = torch.zeros((B, H, D, D), dtype=torch.float32,
                              device=x.device)
            nst = torch.zeros((B, H, D), dtype=torch.float32,
                              device=x.device)
        ys = []
        for t in range(nch):
            yt, Sst, nst = _mlstm_chunk(qc[t], kc[t], vc[t], fc[t], ic[t],
                                        Sst, nst)
            ys.append(yt)
        y = torch.cat(ys, dim=2)[:, :, :S]
        new_cache = None
        if cache is not None:
            new_cache = _copy_into(cache, {"S": Sst, "n": nst})
        elif make_cache:
            new_cache = {"S": Sst, "n": nst}
    y = y.transpose(1, 2).reshape(B, -1, di).to(dt)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    y = y * _silu(z[:, :y.shape[1]])
    return torch.matmul(y, params["w_out"].to(dt)), new_cache


# ================================================================== sLSTM
def slstm(params: Params, x: torch.Tensor, cfg: ModelConfig,
          cache: Optional[Params] = None, make_cache: bool = False,
          valid_len: Optional[int] = None
          ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B, S, d) bf16.  cache = {c, n, h}.  One step per token (the
    hidden-to-hidden recurrence has no parallel form); only the first
    `valid_len` tokens advance the state, and a later position outputs
    the state it holds, as the reference's skipped steps do."""
    B, S, d = x.shape
    H = cfg.ssm_heads
    D = d // H
    pre = _dot_f32(x, params["w_gates"]) + params["gate_bias"].float()
    r_g = params["r_gates"].float()                             # (H,D,4D)
    if cache is not None:
        c, n, h = cache["c"], cache["n"], cache["h"]
    else:
        c = n = h = torch.zeros((B, H, D), dtype=torch.float32,
                                device=x.device)
    n_valid = S if valid_len is None or S == 1 else int(valid_len)

    def steps(state, t0, t1):
        c, n, h = state
        hs = []
        for t in range(t0, t1):
            rec = torch.einsum("bhd,hdg->bhg", h, r_g)
            g = pre[:, t].reshape(B, H, 4 * D) + rec
            i_, f_, z_, o_ = torch.split(g, D, dim=-1)
            i_ = torch.exp(torch.clamp_max(i_, 10.0))
            f_ = _sigmoid(f_)
            z_ = torch.tanh(z_)
            o_ = _sigmoid(o_)
            c = f_ * c + i_ * z_
            n = f_ * n + i_
            h = o_ * c / torch.clamp_min(torch.abs(n), 1.0)
            hs.append(h)
        return (c, n, h), torch.stack(hs, dim=1)

    if _recording(pre, r_g):
        (c, n, h), ys = chunked_scan(steps, (c, n, h), n_valid)
    elif n_valid:
        (c, n, h), y = steps((c, n, h), 0, n_valid)
        ys = [y]
    else:
        ys = []
    # a position past the valid tokens outputs the state it holds
    ys.append(h[:, None].expand(B, S - n_valid, H, D))
    y = torch.cat(ys, dim=1).reshape(B, S, d).to(x.dtype)
    new_cache = None
    if cache is not None:
        new_cache = _copy_into(cache, {"c": c, "n": n, "h": h})
    elif make_cache:
        new_cache = {"c": c, "n": n, "h": h}
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    return torch.matmul(y, params["w_out"].to(x.dtype)), new_cache


# ================================================================== caches
def init_mamba_cache(cfg: ModelConfig, lead: Tuple[int, ...], dtype,
                     device) -> Params:
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": torch.zeros(lead + (cfg.ssm_conv_width - 1, di),
                                dtype=dtype, device=device),
            "h": torch.zeros(lead + (di, cfg.ssm_state),
                             dtype=torch.float32, device=device)}


def init_mlstm_cache(cfg: ModelConfig, lead: Tuple[int, ...],
                     device) -> Params:
    H = cfg.ssm_heads
    D = cfg.ssm_expand * cfg.d_model // H
    return {"S": torch.zeros(lead + (H, D, D), dtype=torch.float32,
                             device=device),
            "n": torch.zeros(lead + (H, D), dtype=torch.float32,
                             device=device)}


def init_slstm_cache(cfg: ModelConfig, lead: Tuple[int, ...],
                     device) -> Params:
    H = cfg.ssm_heads
    shape = lead + (H, cfg.d_model // H)
    return {name: torch.zeros(shape, dtype=torch.float32, device=device)
            for name in ("c", "n", "h")}
