"""qwen1.5-32b [dense] — QKV bias, full MHA-style GQA (kv=40).
[hf:Qwen/Qwen1.5-0.5B]"""
from .base import ATTN_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    pattern=(ATTN_DENSE,),
    qkv_bias=True,
    rope_theta=1000000.0,
)
