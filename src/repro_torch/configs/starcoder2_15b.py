"""starcoder2-15b [dense] — GQA kv=4, RoPE.  [arXiv:2402.19173]"""
from .base import ATTN_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch_type="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    pattern=(ATTN_DENSE,),
    rope_theta=100000.0,
)
