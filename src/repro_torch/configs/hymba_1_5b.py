"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab 32001,
parallel attention + mamba heads per block, SWA (1k) everywhere except
3 global-attention layers, ssm_state=16.  Meta-tokens omitted (orthogonal
to backbone compute).  [arXiv:2411.13676; hf]"""
from repro_torch.nn.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab=32001,
        sliding_window=1024, global_layers=(0, 15, 31),
        ssm_state=16, ssm_expand=2, hybrid_parallel=True,
        scan_layers=True,  # grouped scan: [global, scan·14, global, scan·15, global]
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        sliding_window=16, global_layers=(0,),
        ssm_state=4, ssm_expand=2, hybrid_parallel=True,
        scan_layers=False,
    )
