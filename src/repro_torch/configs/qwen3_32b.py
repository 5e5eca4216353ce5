"""qwen3-32b [dense]: 64L d=5120 64H (GQA kv=8) d_ff=25600 vocab 151936,
qk_norm, head_dim=128.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.nn.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=25600, vocab=151936, qk_norm=True, rope_theta=1e6,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab=512, qk_norm=True, scan_layers=True,
    )
