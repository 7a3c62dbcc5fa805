"""mamba2-370m [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060]"""
from .base import SSM, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    pattern=(SSM,),
    ssm_state=128,
    ssm_head_dim=64,              # d_inner=2048 -> 32 SSD heads
    ssm_expand=2,
    ssm_chunk=256,
    ssm_n_groups=1,
)
