"""Plain PyTorch version of crossbar_mvm — the math of
`repro.kernels.crossbar_mvm.ref.crossbar_mvm_ref`: the port's
`xbar.quant.dot_int8` with the combined scale on the activations.  CPU
tensors take it; `chip_smoke.py` holds the kernel against it on the card."""
import torch

from repro_torch.xbar.quant import QuantParams, dot_int8


def crossbar_mvm_plain(x_codes: torch.Tensor, w_codes: torch.Tensor,
                       zp_x, zp_w, scale) -> torch.Tensor:
    """uint8 (M, K) x uint8 (K, N) -> f32 (M, N) dequantized product;
    zp_x, zp_w, scale (= s_x·s_w) are f32 scalars."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,  # noqa: E731
                                    device=x_codes.device)
    # scale = s_x * s_w; dot_int8 takes them separately — split arbitrarily.
    xq = QuantParams(scale=f32(scale), zero_point=f32(zp_x))
    wq = QuantParams(scale=f32(1.0), zero_point=f32(zp_w))
    return dot_int8(x_codes, w_codes, xq, wq)
