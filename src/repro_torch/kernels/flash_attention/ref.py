"""Plain PyTorch version of the flash-attention forward (naive softmax in
f32), GQA-native like the CUDA kernel: query head h reads KV head
h // (H / Hkv).  The math of
`repro.kernels.flash_attention.ref.flash_attention_ref`.  CPU tensors take
it; `chip_smoke.py` holds the kernel against it on the card."""
import math
from typing import Optional

import torch


def flash_attention_plain(q, k, v, causal: bool = True,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """q (B, Sq, H, D); k/v (B, Skv, Hkv, D) with H % Hkv == 0.  Returns
    (B, Sq, H, D) in q's dtype.  Causal masks key j for query i when
    j > i.  `scale` multiplies the scores (default 1/sqrt(D)).  With
    `return_lse` it returns (o, lse): lse (B, H, Sq) f32, each row's
    log-sum-exp of its scaled scores (`repro.nn.flash._attend_fwd`'s
    `m + log(l)`)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        mask = (torch.arange(Skv, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    o = o.reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
