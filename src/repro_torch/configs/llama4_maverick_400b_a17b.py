"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, interleaved dense/MoE
layers (every other layer is MoE), 1 shared expert, early-fusion multimodal
text backbone.  [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from .base import ATTN_DENSE, ATTN_MOE, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,                    # dense-layer FFN width
    vocab_size=202048,
    head_dim=128,
    pattern=(ATTN_DENSE, ATTN_MOE),   # interleave period 2
    n_groups=24,
    n_experts=128,
    experts_top_k=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    rope_theta=500000.0,
)
