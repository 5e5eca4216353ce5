"""minicpm-2b [dense]: 40L d=2304 36H (MHA) d_ff=5760 vocab 122753,
llama-like, tied embeddings, WSD schedule (repro.optim.schedules.wsd).
[arXiv:2404.06395; hf]"""
from repro_torch.nn.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
        d_ff=5760, vocab=122753, tie_embeddings=True,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, tie_embeddings=True, scan_layers=True,
    )
