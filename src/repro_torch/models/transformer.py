"""Layer stack (mirrors `repro.models.transformer`): the reference's scanned
``(n_groups, ...)`` parameter stacks become one module per layer, in order
group by group, pattern slot by pattern slot: a `Block` for a dense
attention layer ``("attn", "dense")`` and an `SSMBlock` for a Mamba-2 layer
``("ssm", "none")``."""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN_DENSE, SSM
from . import ssm as ssm_mod
from .attention import GQA, gqa_decode, gqa_full
from .layers import MLP, RMSNorm, dtype_of, mlp, rmsnorm

PORTED_SPECS = (ATTN_DENSE, SSM)


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


class SSMBlock(nn.Module):
    """One pre-norm Mamba-2 mixer with no FFN (spec ``("ssm", "none")``)."""

    def __init__(self, cfg, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, dtype_of(cfg), device)
        self.ssm = ssm_mod.SSM(cfg, device)

    def init_(self, generator):
        self.ssm.init_(generator)


def layer_specs(cfg):
    """Layer specs in execution order (``pattern`` x ``n_groups``, then the
    tail); the port runs dense attention and Mamba-2 layers."""
    specs = [tuple(s) for s in list(cfg.pattern) * cfg.n_groups
             + list(cfg.tail_pattern) * cfg.n_tail_groups]
    bad = sorted({s for s in specs if s not in PORTED_SPECS})
    if bad:
        raise NotImplementedError(f"{cfg.name}: layer specs {bad} are not "
                                  f"ported; the port runs {PORTED_SPECS}")
    return specs


def stack_init(cfg, device) -> nn.ModuleList:
    return nn.ModuleList(SSMBlock(cfg, device) if spec == SSM
                         else Block(cfg, device)
                         for spec in layer_specs(cfg))


def _apply_full(blk, cfg, x, positions):
    if isinstance(blk, SSMBlock):
        return x + ssm_mod.ssm_full(blk.ssm, cfg, rmsnorm(blk.norm1, x))
    if x.is_cuda and torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "the flash attention kernel has no backward yet: the port trains "
            "attention-free models on the card")
    x = x + gqa_full(blk.attn, cfg, rmsnorm(blk.norm1, x), positions,
                     causal=True, window=cfg.sliding_window)
    return x + mlp(blk.mlp, rmsnorm(blk.norm2, x))


def stack_full(blocks, cfg, x, positions):
    """Apply the whole stack to a full sequence (training, forward, the
    encoder).  With ``cfg.remat`` and gradients on, each layer is
    recomputed in the backward pass (`torch.utils.checkpoint`), as the
    reference checkpoints each scanned group."""
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in blocks:
        if remat:
            x = checkpoint(_apply_full, blk, cfg, x, positions,
                           use_reentrant=False)
        else:
            x = _apply_full(blk, cfg, x, positions)
    return x


def caches_init(cfg, batch, cache_len, device) -> List[Dict[str, torch.Tensor]]:
    """One cache per layer: for attention {"k", "v"} of (batch, S, KV, hd),
    a ring of S = min(cache_len, window) slots with a sliding window; for
    an SSM layer the conv's trailing inputs and the SSD state."""
    w = cfg.sliding_window
    S = min(cache_len, w) if w else cache_len
    dt = dtype_of(cfg)
    caches = []
    for spec in layer_specs(cfg):
        if spec == SSM:
            caches.append(ssm_mod.ssm_state_init(cfg, batch, device))
            continue
        shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
        caches.append({"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)})
    return caches


def stack_decode(blocks, cfg, caches, x, pos, feed=None):
    """One decode token through the stack; ``caches`` updated in place.
    ``feed`` (B,) bool, when given, names the slots this step feeds: an SSM
    layer keeps the old state of every other slot, so a recurrent state
    only ever holds its own request's tokens.  Attention caches take every
    slot's row (a stray row is overwritten when its slot writes that
    position)."""
    for blk, cache in zip(blocks, caches):
        if isinstance(blk, SSMBlock):
            h, new = ssm_mod.ssm_decode(blk.ssm, cfg, rmsnorm(blk.norm1, x),
                                        cache)
            for key, t in new.items():
                if feed is not None:
                    keep = feed.view(-1, *([1] * (t.ndim - 1)))
                    t = torch.where(keep, t.to(cache[key].dtype), cache[key])
                cache[key].copy_(t)
            x = x + h
            continue
        w = cfg.sliding_window
        ring = w if (w and cache["k"].shape[1] <= w) else 0
        h, cache["k"], cache["v"] = gqa_decode(
            blk.attn, cfg, rmsnorm(blk.norm1, x), cache["k"], cache["v"], pos,
            window=ring)
        x = x + h
        x = x + mlp(blk.mlp, rmsnorm(blk.norm2, x))
    return x, caches
