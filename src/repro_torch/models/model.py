"""Top-level language model, text decoder (mirrors `repro.models.model`):
embedding, layer stack (dense, MoE, MLA + MoE, Mamba-2 and the hybrid's
shared attention block), final norm, LM head.

    lm = init_params(get_config("qwen3-4b"), seed=0, device="cuda")
    caches = init_caches(cfg, batch=4, cache_len=512, device="cuda")
    logits, caches = decode_step(lm, cfg, caches, token, pos)
    logits, aux = forward(lm, cfg, {"tokens": tokens})
    total, metrics = loss_fn(lm, cfg, {"tokens": tokens, "labels": labels})
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
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
        if tfm.has_shared(cfg):
            self.shared = tfm.SharedBlock(cfg, device)


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
    if hasattr(lm, "shared"):
        lm.shared.init_(g)
    return lm


def forward(lm: LM, cfg, batch, long_mode=False):
    """Full-sequence forward (training / prefill).  batch["tokens"]:
    (B, S) int.  Returns (logits (B, S, vocab) f32, aux): aux sums the MoE
    layers' balance losses (0 without MoE).  ``long_mode`` gives the
    hybrid's shared block its sliding window."""
    tokens = batch["tokens"]
    x = lm.embed[tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, aux = tfm.stack_full(lm.blocks, cfg, x, positions,
                            shared=getattr(lm, "shared", None),
                            long_mode=long_mode)
    x = rmsnorm(lm.final_norm, x)
    logits = (x @ lm.lm_head).float()
    return logits, aux


def loss_fn(lm: LM, cfg, batch, aux_weight=0.01):
    """Mean next-token cross-entropy over labels >= 0 (negative labels are
    ignored), plus ``aux_weight`` times the aux loss.  Returns
    (total, metrics) with the reference's metric names."""
    logits, aux = forward(lm, cfg, batch)
    labels = batch["labels"].long()
    valid = labels >= 0
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    n = valid.sum().clamp_min(1)
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / n
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": n.float()}


def prefill(lm: LM, cfg, batch):
    """Logits of the full-sequence forward, as the reference's `prefill`
    (serving fills caches token by token)."""
    return forward(lm, cfg, batch)[0]


def init_caches(cfg, batch, cache_len, device="cuda", long_mode=False):
    return tfm.caches_init(cfg, batch, cache_len, device,
                           long_mode=long_mode)


@torch.no_grad()
def decode_step(lm: LM, cfg, caches, token, pos, feed=None):
    """token: (B, 1) int; pos: (B,) int positions of this token; ``feed``
    (B,) bool, when given, the slots whose recurrent (SSM) state this step
    advances.  Returns (logits (B, vocab) f32, caches updated in place)."""
    x = lm.embed[token]
    x, caches = tfm.stack_decode(lm.blocks, cfg, caches, x, pos, feed=feed,
                                 shared=getattr(lm, "shared", None))
    x = rmsnorm(lm.final_norm, x)
    logits = (x @ lm.lm_head).float()
    return logits[:, 0], caches
