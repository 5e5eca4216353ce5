"""INT8 uniform quantization with zero-point compensation (paper Eq. 6-7)
— PyTorch port of `repro.xbar.quant`.

The paper stores weights as unsigned INT8 codes ``w_q = round(q_w * w_f) - zp_w``
laid out over four 2-bit ReRAM cells.  The §V-C re-encoding adds an ``Offset``
to every code of a layer so the code distribution is centered on a common
``Center``; the *same* offset is subtracted from the zero point used at
de-quantization, so the floating-point dot product is bit-exact unchanged
(up to clipping of codes that leave [0, 255]).

Every division is by a tensor: on a CUDA device PyTorch turns a division
by a Python scalar into a product with its reciprocal, which can move a
code at a .5 boundary away from jnp's true f32 division.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

UINT_MAX = 255


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Uniform affine quantization parameters for one tensor.

    code = clip(round(w / scale) + zero_point, 0, 255)
    w̃   = (code - zero_point) * scale
    """

    scale: torch.Tensor       # f32 scalar (or per-channel vector)
    zero_point: torch.Tensor  # f32, same shape as scale

    def shifted(self, offset: torch.Tensor) -> "QuantParams":
        """Compensate a code-domain shift by ``offset`` (Eq. 7's zp_w - Offset)."""
        return QuantParams(self.scale, self.zero_point + offset)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def quantize_tensor(w: torch.Tensor, axis=None
                    ) -> Tuple[torch.Tensor, QuantParams]:
    """Symmetric-range uniform quantization of ``w`` to uint8 codes.

    ``axis``: None for per-tensor, or an int for per-channel params
    (reduction is performed over the *other* axes).
    """
    w = w.to(torch.float32)
    if axis is None:
        lo, hi = w.min(), w.max()
    else:
        axes = tuple(i for i in range(w.ndim) if i != axis)
        lo = w.amin(dim=axes, keepdim=True)
        hi = w.amax(dim=axes, keepdim=True)
    # Guard degenerate range.
    scale = torch.clamp_min(hi - lo, 1e-8) / _f32(UINT_MAX, w.device)
    zero_point = -lo / scale  # code for w == 0.0 (affine: code = w/scale + zp)
    return quantize(w, QuantParams(scale, zero_point)), \
        QuantParams(scale=scale, zero_point=zero_point)


def quantize(w: torch.Tensor, params: QuantParams) -> torch.Tensor:
    code = torch.round(w.to(torch.float32) / params.scale + params.zero_point)
    return torch.clamp(code, 0, UINT_MAX).to(torch.uint8)


def dequantize(code: torch.Tensor, params: QuantParams) -> torch.Tensor:
    return (code.to(torch.float32) - params.zero_point) * params.scale


def shift_weights(code: torch.Tensor, center
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Eq. 4-5: shift all codes of a layer so their mean lands on ``center``.

    Returns (new_code, offset).  Codes are clipped to [0, 255]; the caller is
    responsible for compensating ``offset`` in the zero point (Eq. 7) and for
    checking the clip rate (accuracy proxy).
    """
    offset = torch.round(_f32(center, code.device)
                         - code.to(torch.float32).mean())
    new_code = torch.clamp(code.to(torch.int32) + offset.to(torch.int32),
                           0, UINT_MAX)
    return new_code.to(torch.uint8), offset


def clip_rate(code: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Fraction of codes that saturate when shifted by ``offset`` (accuracy proxy)."""
    shifted = code.to(torch.int32) + torch.as_tensor(offset).to(torch.int32)
    return ((shifted < 0) | (shifted > UINT_MAX)).to(torch.float32).mean()


def int_matmul(x_code: torch.Tensor, w_code: torch.Tensor) -> torch.Tensor:
    """uint8 (..., K) @ uint8 (K, N) -> the exact int32 products.  The sums
    run in float64, which holds every partial sum exactly (each is below
    255²·K < 2**53) on any device — PyTorch has no int32 matmul on CUDA."""
    return torch.matmul(x_code.to(torch.float64),
                        w_code.to(torch.float64)).to(torch.int32)


def dot_int8(
    x_code: torch.Tensor,
    w_code: torch.Tensor,
    x_params: QuantParams,
    w_params: QuantParams,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """De-quantized dot product (paper Eq. 7), the plain PyTorch version.

    ``x_code``: (..., K) uint8 activations; ``w_code``: (K, N) uint8 weights.
    Computes yf = sum_k (x - zp_x)*sx * (w - zp_w)*sw + b using integer
    accumulation plus the standard zero-point correction terms, in the
    reference's f32 order — the identity under which the §V-C weight shift
    is free (Offset folded into zp_w).  This is the plain version behind
    the `crossbar_mvm` kernel.
    """
    acc = int_matmul(x_code, w_code)
    k = x_code.shape[-1]
    # Zero-point corrections: (x - zpx)·(w - zpw) = xw - zpw·Σx - zpx·Σw + K·zpx·zpw
    sum_x = x_code.to(torch.int32).sum(dim=-1, keepdim=True).to(torch.float32)
    sum_w = w_code.to(torch.int32).sum(dim=0, keepdim=True).to(torch.float32)
    zpx = x_params.zero_point
    zpw = w_params.zero_point
    y = (
        acc.to(torch.float32)
        - zpw * sum_x
        - zpx * sum_w
        + k * zpx * zpw
    ) * (x_params.scale * w_params.scale)
    if bias is not None:
        y = y + bias
    return y
