"""internvl2-76b [vlm] — InternViT (stubbed as patch embeddings) feeding an
80-layer InternLM2/LLaMA3-style dense decoder.  [arXiv:2404.16821]"""
from .base import ATTN_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    pattern=(ATTN_DENSE,),
    rope_theta=500000.0,
    frontend="vision",
    frontend_dim=3200,            # InternViT-6B hidden size
    num_patches=256,              # image tokens prepended to the text
)
