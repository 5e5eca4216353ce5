"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4) MoE 128e top-8,
expert d_ff=1536, vocab 151936, qk_norm.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.nn.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab=151936, qk_norm=True, rope_theta=1e6,
        n_experts=128, moe_topk=8, d_ff_expert=1536,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=512, qk_norm=True,
        n_experts=8, moe_topk=2, d_ff_expert=96,
        scan_layers=True,
    )
