"""gemma-7b [dense]: 28L d=3072 16H (MHA kv=16) GeGLU d_ff=24576,
head_dim=256, vocab 256000, tied embeddings.  [arXiv:2403.08295; hf]"""
from repro_torch.nn.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000, act="gelu", tie_embeddings=True,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=192, vocab=512, act="gelu", tie_embeddings=True,
        scan_layers=True,
    )
