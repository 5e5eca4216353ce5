"""Unified model configuration covering the 10 assigned architectures."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # defaults to d_model // n_heads

    # attention
    attn_type: str = "gqa"           # gqa | mla | none
    causal: bool = True
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention
    global_layers: Tuple[int, ...] = ()  # layers overriding sliding window
    logit_softcap: float = 0.0

    # FFN
    act: str = "silu"                # silu | gelu (gelu → GeGLU when gated)
    gated: bool = True

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_topk: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0      # leading dense layers (deepseek)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM
    ssm_state: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_heads: int = 0               # xlstm heads
    slstm_every: int = 0             # 1-in-N blocks are sLSTM (xlstm)
    hybrid_parallel: bool = False    # hymba: attn ∥ mamba in every block

    # modality frontend stubs
    input_mode: str = "tokens"       # tokens | embeddings | prefix_vlm
    prefix_len: int = 0              # image patches for VLM prefix

    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    scan_layers: bool = True         # lax.scan over stacked layer params
    remat: bool = True
    # KV cache numerics: 'bf16' or 'int8' (per-token-per-head absmax scales;
    # the paper's INT8-cell storage applied to the KV crossbar — halves the
    # dominant decode HBM footprint).  GQA caches only; MLA's latent cache
    # is already compressed.
    kv_cache_dtype: str = "bf16"
    # Dry-run cost probes only: replace lax.scan/map chunk loops with python
    # loops so XLA cost_analysis (which counts while bodies once) sees every
    # FLOP.  Never enabled on the real execution path.
    unroll_chunks: bool = False
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over 16-way TP."""
        return math.ceil(self.vocab / 256) * 256

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def layer_is_moe(self) -> Tuple[bool, ...]:
        if self.n_experts == 0:
            return tuple(False for _ in range(self.n_layers))
        return tuple(i >= self.first_dense_layers for i in range(self.n_layers))

    def window_for_layer(self, i: int) -> int:
        if self.sliding_window and i not in self.global_layers:
            return self.sliding_window
        return 0  # full attention

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once if tied)."""
        d, l = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.attn_type == "mla":
            attn = d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
            attn += d * (self.kv_lora_rank + self.qk_rope_dim)
            attn += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            attn += self.n_heads * self.v_head_dim * d
        elif self.attn_type == "none":
            attn = 0
        else:
            attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        ff_mult = 3 if self.gated else 2
        dense_ff = ff_mult * d * self.d_ff
        n_moe = sum(self.layer_is_moe)
        n_dense = l - n_moe
        moe_ff = ff_mult * d * self.d_ff_expert * (self.n_experts + self.n_shared_experts)
        total = emb + l * attn + n_dense * dense_ff + n_moe * moe_ff
        if self.hybrid_parallel:
            di = self.ssm_expand * d
            total += l * (2 * d * di + di * d + di * (2 * self.ssm_state + 2))
        if self.family == "ssm":
            # xlstm blocks replace attention entirely; rough estimate
            di = self.ssm_expand * d
            total = emb + l * (2 * d * di + di * d + 4 * di * di // max(self.ssm_heads, 1))
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if self.n_experts == 0:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        full = self.param_count()
        ff_mult = 3 if self.gated else 2
        moe_all = ff_mult * d * self.d_ff_expert * self.n_experts
        moe_active = ff_mult * d * self.d_ff_expert * self.moe_topk
        n_moe = sum(self.layer_is_moe)
        return int(full - n_moe * (moe_all - moe_active))
