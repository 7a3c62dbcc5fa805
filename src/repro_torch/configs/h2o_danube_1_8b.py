"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""
from .base import ATTN_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    arch_type="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    pattern=(ATTN_DENSE,),
    sliding_window=4096,          # mistral-style SWA -> long_500k eligible
    rope_theta=10000.0,
)
