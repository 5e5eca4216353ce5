"""xlstm-350m [ssm]: 24 blocks d=1024 4 heads, mLSTM + sLSTM (1-in-8),
vocab 50304, no FFN blocks (d_ff=0; mLSTM carries the 2x up-projection).
[arXiv:2405.04517; unverified]"""
from repro_torch.nn.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
        d_ff=0, vocab=50304, attn_type="none",
        ssm_heads=4, ssm_expand=2, slstm_every=8,
        scan_layers=True,  # grouped scan: (scan·7 mLSTM + sLSTM) × 3
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=0, vocab=512, attn_type="none",
        ssm_heads=2, ssm_expand=2, slstm_every=2,
        scan_layers=False,
    )
