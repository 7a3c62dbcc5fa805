"""Shared low-level layers (mirrors `repro.models.layers`): RMSNorm,
half-split RoPE, SwiGLU MLP and the truncated-normal fan-in init.

Weights keep the reference's (in, out) layout, so ``y = x @ w`` and a JAX
parameter converts by copy (`convert.params_from_jax`).  Parameters are
inference-only (``requires_grad=False``)."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param(shape, dtype, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


@torch.no_grad()
def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale=None) -> None:
    """Truncated-normal fan-in init in place, like `layers.dense_init`:
    N(0, 1) truncated to [-2, 2], times ``scale`` or 1/sqrt(fan_in).  Drawn
    in f32 from ``generator`` (on ``w``'s device), then cast."""
    fan_in = w.shape[-2] if w.ndim >= 2 else w.shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    x = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    x.uniform_(lo, hi, generator=generator)
    x.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)
    w.copy_(x)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = param((d,), dtype, device, fill=1.0)

    def forward(self, x):
        return rmsnorm(self, x)


def rmsnorm(p: RMSNorm, x, eps=1e-6):
    """Computed in f32, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh); positions broadcastable to (..., S).  Half-split
    layout: the first and second halves of Dh form the rotated pairs."""
    inv_freq = torch.from_numpy(rope_frequencies(x.shape[-1], theta)).to(
        x.device)
    ang = positions[..., None].float() * inv_freq
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_model, d_ff, dtype, device):
        super().__init__()
        self.w_gate = param((d_model, d_ff), dtype, device)
        self.w_up = param((d_model, d_ff), dtype, device)
        self.w_down = param((d_ff, d_model), dtype, device)

    def init_(self, generator):
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)

    def forward(self, x):
        return mlp(self, x)


def mlp(p: MLP, x):
    g = x @ p.w_gate
    u = x @ p.w_up
    return (torch.nn.functional.silu(g) * u) @ p.w_down
