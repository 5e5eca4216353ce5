"""deepseek-v2-lite-16b [moe]: 27L d=2048, MLA kv_lora=512, 64 routed
experts top-6 + 2 shared, expert d_ff=1408, first layer dense (d_ff=10944),
vocab 102400.  [arXiv:2405.04434; hf]"""
from repro_torch.nn.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944, vocab=102400, attn_type="mla",
        kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        head_dim=192,  # nope + rope
        n_experts=64, n_shared_experts=2, moe_topk=6, d_ff_expert=1408,
        first_dense_layers=1,
        scan_layers=True,  # grouped scan: [dense, scan·26]
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, attn_type="mla",
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        head_dim=24,
        n_experts=8, n_shared_experts=2, moe_topk=2, d_ff_expert=48,
        first_dense_layers=1, scan_layers=False,
    )
