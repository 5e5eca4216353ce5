"""Flash attention with a FlashAttention-2 backward — PyTorch port of
`repro.nn.flash` (`flash_chunked` and its custom VJP) as a
`torch.autograd.Function`.

The forward is the flash kernel (`kernels.flash_attention`), which also
writes each row's log-sum-exp: on a CUDA tensor the hand-written kernel
(bf16 or f32 by dtype), on a CPU tensor its plain version.  Only
(q, k, v, o, lse) are saved.  The backward recomputes each block's
probabilities from lse, as the reference's `_vjp_bwd` does, in f32 and in
its q_chunk / kv_chunk blocks and order:

  Δ = rowsum(do ⊙ o); per kv block, per q block: p = exp(s − lse);
  dv += pᵀ·do; ds = p ⊙ (do·vᵀ − Δ)·scale; dk += dsᵀ·q; dq += ds·k

The reference runs this backward as jnp code, with no Pallas kernel, so
here it stays torch ops.  A causal block that lies wholly above the
diagonal is skipped: its probabilities are exactly 0, so it adds exact
zeros in the reference.

Layout is the kernel's: q (B, Sq, H, D), k/v (B, Skv, Hkv, D), query
head h reading KV head h // (H / Hkv); dk and dv sum each KV head's G
query heads.  The kernel zero-pads an off-native head dim; the backward
works at the true D with the true 1/sqrt(D).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -2.0e38


def flash_backward(q, k, v, o, lse, do, causal: bool, q_chunk: int = 512,
                   kv_chunk: int = 1024):
    """The reference's `_vjp_bwd` in the kernel's layout: returns
    (dq, dk, dv) in the dtypes of q, k and v, computed in f32."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    # the reference's layout: (B, Hkv, G, S, D) queries, (B, Hkv, S, D) keys
    qf = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    dof = do.float().reshape(B, Sq, Hkv, G, -1).permute(0, 2, 3, 1, 4)
    of = o.float().reshape(B, Sq, Hkv, G, -1).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    lsef = lse.float().reshape(B, Hkv, G, Sq)
    delta = torch.sum(dof * of, dim=-1)                     # (B,Hkv,G,Sq)
    dq = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for j0 in range(0, Skv, kv_chunk):
        j1 = min(Skv, j0 + kv_chunk)
        kb, vb = kf[:, :, j0:j1], vf[:, :, j0:j1]
        kpos = torch.arange(j0, j1, device=dev)
        dk_acc = torch.zeros((B, Hkv, j1 - j0, D), dtype=torch.float32,
                             device=dev)
        dv_acc = torch.zeros((B, Hkv, j1 - j0, vf.shape[-1]),
                             dtype=torch.float32, device=dev)
        for i0 in range(0, Sq, q_chunk):
            i1 = min(Sq, i0 + q_chunk)
            if causal and j0 > i1 - 1:
                continue                     # every score masked: p == 0
            qb, dob = qf[:, :, :, i0:i1], dof[:, :, :, i0:i1]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
            if causal and j1 - 1 > i0:       # the block meets the diagonal
                qpos = torch.arange(i0, i1, device=dev)
                ok = kpos[None, :] <= qpos[:, None]
                s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            p = torch.exp(s - lsef[:, :, :, i0:i1, None])
            dv_acc = dv_acc + torch.einsum("bhgqk,bhgqd->bhkd", p, dob)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vb)
            ds = p * (dp - delta[:, :, :, i0:i1, None]) * scale
            dk_acc = dk_acc + torch.einsum("bhgqk,bhgqd->bhkd", ds, qb)
            dq[:, :, :, i0:i1] += torch.einsum("bhgqk,bhkd->bhgqd", ds, kb)
        dks.append(dk_acc)
        dvs.append(dv_acc)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3)
    dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """o = softmax(q·kᵀ/sqrt(D))·v through the flash kernel, with the
    reference's flash backward.  Use `flash_attention_train`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_chunk: int, kv_chunk: int):
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_chunk, ctx.kv_chunk = causal, q_chunk, kv_chunk
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.causal,
                                    ctx.q_chunk, ctx.kv_chunk)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, causal: bool = True, q_chunk: int = 512,
                          kv_chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D) -> o (B, Sq, H, D) in q's
    dtype, differentiable in q, k and v (one kernel launch forward)."""
    return FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk)
