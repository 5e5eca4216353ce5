"""hubert-xlarge [audio]: 48L encoder-only d=1280 16H d_ff=5120 vocab 504
(masked-prediction codebook).  Modality frontend is a stub: input_specs
provides precomputed frame embeddings.  [arXiv:2106.07447; unverified]"""
from repro_torch.nn.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="encoder",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab=504, causal=False, gated=False, act="gelu",
        input_mode="embeddings", scan_layers=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", family="encoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=96, causal=False, gated=False, act="gelu",
        input_mode="embeddings", scan_layers=True,
    )
