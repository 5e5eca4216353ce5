"""paligemma-3b [vlm]: gemma-2B-class decoder 18L d=2048 8H (MQA kv=1)
GeGLU d_ff=16384, head_dim=256, vocab 257216; SigLIP frontend is a stub
(precomputed patch embeddings, 256 patches, prefix attention).
[arXiv:2407.07726; hf]"""
from repro_torch.nn.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab=257216, act="gelu",
        input_mode="prefix_vlm", prefix_len=256, tie_embeddings=True,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, act="gelu",
        input_mode="prefix_vlm", prefix_len=4, tie_embeddings=True,
        scan_layers=True,
    )
