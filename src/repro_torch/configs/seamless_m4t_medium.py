"""seamless-m4t-medium [audio] — encoder-decoder; the speech frontend
(mel + conformer feature extractor) is stubbed as precomputed frame
embeddings; we implement the transformer encoder + text decoder with
cross-attention.  [arXiv:2308.11596]"""
from .base import ATTN_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12,                  # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    pattern=(ATTN_DENSE,),
    encoder_layers=12,
    frontend="audio",
    frontend_dim=1024,            # stubbed codec embedding dim
)
