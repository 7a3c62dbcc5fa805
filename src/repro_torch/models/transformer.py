"""Layer stack, dense path (mirrors `repro.models.transformer`): the
reference's scanned ``(n_groups, ...)`` parameter stacks become one
`Block` module per layer, in order group by group, pattern slot by pattern
slot."""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from repro_torch.configs.base import ATTN_DENSE
from .attention import GQA, gqa_decode, gqa_full
from .layers import MLP, RMSNorm, dtype_of, mlp, rmsnorm


class Block(nn.Module):
    """One pre-norm attention + SwiGLU block (spec ``("attn", "dense")``)."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg)
        self.norm1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = GQA(cfg, device)
        self.norm2 = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)

    def init_(self, generator):
        self.attn.init_(generator)
        self.mlp.init_(generator)


def layer_specs(cfg):
    """Layer specs in execution order (``pattern`` x ``n_groups``, then the
    tail); the port runs dense attention blocks only."""
    specs = list(cfg.pattern) * cfg.n_groups \
        + list(cfg.tail_pattern) * cfg.n_tail_groups
    bad = sorted({s for s in specs if tuple(s) != ATTN_DENSE})
    if bad:
        raise NotImplementedError(f"{cfg.name}: layer specs {bad} are not "
                                  f"ported; the port runs dense attention "
                                  f"blocks {ATTN_DENSE} only")
    return specs


def stack_init(cfg, device) -> nn.ModuleList:
    return nn.ModuleList(Block(cfg, device) for _ in layer_specs(cfg))


def stack_full(blocks, cfg, x, positions):
    """Apply the whole stack to a full sequence (encoder / prefill)."""
    for blk in blocks:
        x = x + gqa_full(blk.attn, cfg, rmsnorm(blk.norm1, x), positions,
                         causal=True, window=cfg.sliding_window)
        x = x + mlp(blk.mlp, rmsnorm(blk.norm2, x))
    return x


def caches_init(cfg, batch, cache_len, device) -> List[Dict[str, torch.Tensor]]:
    """One {"k", "v"} cache of (batch, S, KV, hd) per layer; with a sliding
    window the cache is a ring of S = min(cache_len, window) slots."""
    w = cfg.sliding_window
    S = min(cache_len, w) if w else cache_len
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype_of(cfg)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in layer_specs(cfg)]


def stack_decode(blocks, cfg, caches, x, pos):
    """One decode token through the stack; ``caches`` updated in place."""
    for blk, cache in zip(blocks, caches):
        w = cfg.sliding_window
        ring = w if (w and cache["k"].shape[1] <= w) else 0
        h, cache["k"], cache["v"] = gqa_decode(
            blk.attn, cfg, rmsnorm(blk.norm1, x), cache["k"], cache["v"], pos,
            window=ring)
        x = x + h
        x = x + mlp(blk.mlp, rmsnorm(blk.norm2, x))
    return x, caches
