"""zamba2-7b [hybrid] — Mamba-2 backbone with a single SHARED transformer
block applied every 6th position: 81 blocks = 13 x (5 mamba + shared-attn)
+ 3 trailing mamba.  [arXiv:2411.15242]"""
from .base import SHARED_ATTN, SSM, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,                   # shared block MLP width
    vocab_size=32000,
    pattern=(SSM, SSM, SSM, SSM, SSM, SHARED_ATTN),
    n_groups=13,
    tail_pattern=(SSM,),
    n_tail_groups=3,
    ssm_state=64,
    ssm_head_dim=64,              # d_inner=7168 -> 112 SSD heads
    ssm_expand=2,
    ssm_chunk=256,
    ssm_n_groups=1,
    shared_attn_window=4096,      # used in long_500k mode
)
