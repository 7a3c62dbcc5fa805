"""qwen3-4b [dense] — qk-norm + GQA.  [hf:Qwen/Qwen3-8B]"""
from .base import ATTN_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    arch_type="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,                 # Qwen3 uses decoupled head_dim=128
    pattern=(ATTN_DENSE,),
    qk_norm=True,
    rope_theta=1000000.0,
)
