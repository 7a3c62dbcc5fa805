"""Top-level language model, dense text decoder (mirrors
`repro.models.model`): embedding, layer stack, final norm, LM head.

    lm = init_params(get_config("qwen3-4b"), seed=0, device="cuda")
    caches = init_caches(cfg, batch=4, cache_len=512, device="cuda")
    logits, caches = decode_step(lm, cfg, caches, token, pos)
"""
from __future__ import annotations

import torch
from torch import nn

from . import transformer as tfm
from .layers import RMSNorm, dense_init_, dtype_of, param, rmsnorm


class LM(nn.Module):
    """Parameters of one model; built empty, filled by `init_params` or
    `convert.params_from_jax`."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        dt = dtype_of(cfg)
        self.embed = param((cfg.vocab_size, cfg.d_model), dt, device)
        self.final_norm = RMSNorm(cfg.d_model, dt, device)
        self.lm_head = param((cfg.d_model, cfg.vocab_size), dt, device)
        self.blocks = tfm.stack_init(cfg, device)


def init_params(cfg, seed: int = 0, device="cuda") -> LM:
    """Seeded init: truncated-normal fan-in like the reference's
    `init_params`, drawn from a `torch.Generator` on ``device`` (so the
    numbers differ from JAX's and between device types)."""
    lm = LM(cfg, device)
    g = torch.Generator(device=device).manual_seed(seed)
    dense_init_(lm.embed, g, scale=1.0)
    dense_init_(lm.lm_head, g)
    for blk in lm.blocks:
        blk.init_(g)
    return lm


def init_caches(cfg, batch, cache_len, device="cuda"):
    return tfm.caches_init(cfg, batch, cache_len, device)


@torch.no_grad()
def decode_step(lm: LM, cfg, caches, token, pos):
    """token: (B, 1) int; pos: (B,) int positions of this token.
    Returns (logits (B, vocab) f32, caches updated in place)."""
    x = lm.embed[token]
    x, caches = tfm.stack_decode(lm.blocks, cfg, caches, x, pos)
    x = rmsnorm(lm.final_norm, x)
    logits = (x @ lm.lm_head).float()
    return logits[:, 0], caches
