"""Architecture registry of the port.

Each module exposes ``full()`` (the exact published config) and ``smoke()``
(a reduced same-family config for CPU tests), as in the JAX package.  The
registry holds every family of the reference's: the dense GQA decoders
(gemma-7b, minicpm-2b, yi-34b, qwen3-32b), the MoE ones
(deepseek-v2-lite-16b with MLA, qwen3-moe-235b-a22b with GQA), the
recurrent ones (hymba-1.5b, SWA attention beside mamba in every block;
xlstm-350m, mLSTM and sLSTM blocks) and the two non-token input modes
(hubert-xlarge, an encoder over frame embeddings; paligemma-3b, a decoder
behind 256 image-prefix positions).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs import (
    deepseek_v2_lite_16b,
    gemma_7b,
    hubert_xlarge,
    hymba_1_5b,
    minicpm_2b,
    paligemma_3b,
    qwen3_32b,
    qwen3_moe_235b_a22b,
    xlstm_350m,
    yi_34b,
)
from repro_torch.nn.config import ModelConfig

_MODULES = {
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "hubert-xlarge": hubert_xlarge,
    "hymba-1.5b": hymba_1_5b,
    "paligemma-3b": paligemma_3b,
    "minicpm-2b": minicpm_2b,
    "qwen3-32b": qwen3_32b,
    "yi-34b": yi_34b,
    "gemma-7b": gemma_7b,
    "xlstm-350m": xlstm_350m,
}

ARCHS: Tuple[str, ...] = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[name]
    return mod.smoke() if smoke else mod.full()


#: Shapes each arch supports, as the reference lists them: long_500k
#: needs sub-quadratic attention; encoder-only archs have no decode step.
def supported_shapes(name: str) -> Tuple[str, ...]:
    cfg = get_config(name)
    shapes = ["train_4k", "prefill_32k"]
    if not cfg.is_encoder:
        shapes.append("decode_32k")
        sub_quadratic = cfg.family in ("ssm",) or (
            cfg.sliding_window > 0 or cfg.hybrid_parallel)
        if sub_quadratic:
            shapes.append("long_500k")
    return tuple(shapes)
