"""Deterministic query embedder (mirrors `repro.serving.encoder`): hash
tokenizer + a 2-layer dense transformer encoder (d = 768, 12 heads, f32),
mean-pooled over non-pad tokens and L2-normalized.

The encoder's attention runs causal, as the reference's `stack_full` does,
through the forward attention kernel on a CUDA device.  Params are the
port's own seeded init (drawn on the CPU, so every device gets the same
weights), or converted JAX params (`models.convert.params_from_jax`)."""
from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ATTN_DENSE, ModelConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm

_VOCAB = 8192
_MAXLEN = 64
_CHUNK = 1024           # texts per encoder call

ENCODER_CFG = ModelConfig(
    name="query-encoder", arch_type="dense", n_layers=2, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=1536, vocab_size=_VOCAB,
    pattern=(ATTN_DENSE,), n_groups=2, dtype="float32", remat=False)


def hash_tokenize(text: str, max_len: int = _MAXLEN) -> np.ndarray:
    toks = []
    for w in text.lower().split()[:max_len]:
        h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
        toks.append(h % (_VOCAB - 2) + 2)
    if not toks:
        toks = [1]
    out = np.zeros(max_len, np.int32)
    out[: len(toks)] = toks[: max_len]
    return out


class QueryEncoder:
    """Text -> unit-norm (n, 768) f32 embeddings on ``device``."""

    def __init__(self, params: Optional[M.LM] = None, *, device="cuda"):
        self.cfg = ENCODER_CFG
        self.device = torch.device(device)
        if params is None:
            params = M.init_params(self.cfg, seed=7, device="cpu")
        self.params = params.to(self.device)

    @torch.no_grad()
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (n, L) int on ``device`` -> mean-pooled (n, D) f32."""
        x = self.params.embed[tokens]
        pos = torch.arange(x.shape[1], device=x.device)[None].expand(
            x.shape[0], -1)
        h = tfm.stack_full(self.params.blocks, self.cfg, x, pos)
        mask = (tokens > 0).float()[..., None]
        return (h * mask).sum(1) / mask.sum(1).clamp_min(1.0)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Embeds ``_CHUNK`` texts per encoder call; returns host numpy."""
        toks = np.stack([hash_tokenize(t) for t in texts])
        parts = []
        for i in range(0, len(toks), _CHUNK):
            t = torch.from_numpy(toks[i:i + _CHUNK]).to(self.device)
            parts.append(self.embed_tokens(t.long()).cpu().numpy())
        emb = np.concatenate(parts)
        emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
        return emb.astype(np.float32)


@lru_cache(maxsize=None)
def default_encoder(device="cuda") -> QueryEncoder:
    """One seeded encoder per device, built at first use."""
    return QueryEncoder(device=device)
