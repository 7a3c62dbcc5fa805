"""Plain reference of ``h2o-danube-1.8b`` training: the decoder in float32
PyTorch (TF32 off), its next-token loss, its gradient by autograd and the
AdamW step, imported by nothing of the port.

- Model (Mistral layout, arXiv:2401.16818): token embedding; 24 pre-norm
  blocks of grouped-query attention (32 query heads, 8 key / value heads
  of 80, half-split RoPE at theta 10,000, causal with a sliding window of
  4,096) and a SwiGLU MLP of 6,912; a final RMSNorm; an untied LM head.
  RMSNorm's epsilon is the configuration's (1e-6, as the port runs it;
  the published config states 1e-5).  Each block is recomputed in the
  backward pass (checkpointed), which changes no number.
- Loss: the mean over every position of the negative log-likelihood of
  the next token (labels below 0 would be ignored; the stream has none).
- AdamW as the configuration states it: the gradient clipped to global
  norm ``clip_norm``; m and v with bias correction; decoupled weight decay
  on the weights; the learning rate warm for ``warmup_steps`` and then on
  a cosine to ``min_lr_ratio`` over ``total_steps``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import plain


def lm_specs(c: dict):
    """Every leaf, named as the port names its parameters."""
    d, V = c["hidden_size"], c["vocab_size"]
    specs = [("embed", (V, d), 1.0),
             ("lm_head", (d, V), 1 / math.sqrt(d)),
             ("final_norm.scale", (d,), None)]
    for i in range(c["num_hidden_layers"]):
        specs += plain.block_specs(f"blocks.{i}", d,
                                   c["num_attention_heads"],
                                   c["num_key_value_heads"], c["head_dim"],
                                   c["intermediate_size"])
    return specs


def _consts(c):
    return dict(H=c["num_attention_heads"], KV=c["num_key_value_heads"],
                hd=c["head_dim"], eps=c["rms_norm_eps"],
                theta=c["rope_theta"], window=c["sliding_window"])


def loss(w: dict, c: dict, tokens, labels, pr: plain.Precision):
    consts = _consts(c)
    x = w["embed"][tokens]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for i in range(c["num_hidden_layers"]):
        x = checkpoint(plain.block, x, w, f"blocks.{i}", pos, consts, pr,
                       use_reentrant=False)
    x = plain.rmsnorm(x, w["final_norm.scale"], c["rms_norm_eps"])
    logits = pr.mm(x, w["lm_head"])
    valid = labels >= 0
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.clamp_min(0).reshape(-1),
                          reduction="none").reshape(labels.shape)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() \
        / valid.sum().clamp_min(1)


def lr_at(o: dict, step: int) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((step - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return o["lr"] * warm * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * cos)


class AdamW:
    def __init__(self, params: dict, o: dict):
        self.o = o
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """One update in place; returns each leaf's clipped gradient
        norm."""
        o = self.o
        self.t += 1
        gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                              for g in grads.values()))
        scale = min(o["clip_norm"] / (gnorm + 1e-9), 1.0)
        lr = lr_at(o, self.t)
        bc1 = 1 - o["b1"] ** self.t
        bc2 = 1 - o["b2"] ** self.t
        norms = {}
        for n, p in params.items():
            g = grads[n] * scale
            norms[n] = float(g.norm())
            self.m[n].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.v[n].mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
            upd = (self.m[n] / bc1) / ((self.v[n] / bc2).sqrt() + o["eps"])
            p.sub_(lr * (upd + o["weight_decay"] * p))
        return norms
