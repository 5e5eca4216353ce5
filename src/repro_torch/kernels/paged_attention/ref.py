"""Plain PyTorch version of paged decode attention (gather + naive softmax
in f32) — the same function the CUDA kernel computes, and the math of
`repro.kernels.paged_attention.ref.paged_attention_ref`.  CPU tensors take
it; `chip_smoke.py` holds the kernel against it on the card."""
import math

import torch


def paged_attention_plain(q, k_pool, v_pool, tables, pos) -> torch.Tensor:
    """q (B, H, D); k/v_pool (P, page, Hkv, D); tables (B, T) int32;
    pos (B,) int32.  Returns (B, H, D) in q's dtype: one decode step
    attending over positions <= pos[b] gathered through each row's page
    table."""
    B, H, D = q.shape
    P, page, Hkv, _ = k_pool.shape
    T = tables.shape[1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    idx = tables.long()
    kc = k_pool[idx].reshape(B, T * page, Hkv, D)
    vc = v_pool[idx].reshape(B, T * page, Hkv, D)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), kc.float()) * scale
    kpos = torch.arange(T * page, device=q.device)
    valid = kpos[None, :] <= pos.long()[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, vc.float())
    return o.reshape(B, H, D).to(q.dtype)
