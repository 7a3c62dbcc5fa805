"""deepseek-v2-236b [moe] — MLA (kv_lora=512, q_lora=1536, decoupled RoPE) +
160 routed experts top-6 with 2 shared experts.  [arXiv:2405.04434]"""
from .base import MLA_MOE, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,               # MLA: logical heads (cache is latent)
    d_ff=12288,                   # (unused: all layers MoE; see DESIGN note)
    vocab_size=102400,
    head_dim=128,
    pattern=(MLA_MOE,),
    n_experts=160,
    experts_top_k=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)
