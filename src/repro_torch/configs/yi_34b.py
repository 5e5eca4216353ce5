"""yi-34b [dense]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab 64000,
llama arch.  [arXiv:2403.04652; hf]"""
from repro_torch.nn.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=20480, vocab=64000, rope_theta=5e6,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab=512, scan_layers=True,
    )
