"""Shared low-level layers (mirrors `repro.models.layers`): RMSNorm,
half-split RoPE (with DeepSeek-V2's YaRN scaling where a config asks for
it), SwiGLU MLP and the truncated-normal fan-in init.

Weights keep the reference's (in, out) layout, so ``y = x @ w`` and a JAX
parameter converts by copy (`convert.params_from_jax`).  Parameters are
inference-only (``requires_grad=False``)."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch import tracing


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

def rope_frequencies(head_dim: int, theta: float, scaling=()):
    """Inverse frequencies of the head_dim / 2 rotated pairs; with
    ``scaling`` (a config's ``rope_scaling`` pairs) of type yarn, YaRN's
    (`yarn_frequencies`)."""
    half = head_dim // 2
    if scaling:
        return yarn_frequencies(head_dim, theta, dict(scaling))
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor: 0.1 mscale ln(factor) + 1 (1 at factor
    <= 1)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_frequencies(dim: int, theta: float, s: dict) -> np.ndarray:
    """DeepSeek-V2's YaRN (`DeepseekV2YarnRotaryEmbedding`), for pair i of
    ``dim`` / 2:

        freq_extra_i = theta^(-2i / dim),  freq_inter_i = freq_extra_i / factor
        d(r) = dim ln(L / (2 pi r)) / (2 ln theta)     (L: the original length)
        lo = max(floor(d(beta_fast)), 0), hi = min(ceil(d(beta_slow)), dim-1)
        ramp_i = clamp((i - lo) / (hi - lo), 0, 1),  mask_i = 1 - ramp_i
        inv_freq_i = freq_inter_i (1 - mask_i) + freq_extra_i mask_i

    (hi = lo + 0.001 where they meet), in float32."""
    if s.get("type", "yarn") != "yarn":
        raise NotImplementedError(f"rope_scaling {s.get('type')!r}: only "
                                  f"yarn is ported")
    factor = float(s["factor"])
    L = float(s["original_max_position_embeddings"])

    def corr(r):
        return dim * math.log(L / (r * 2 * math.pi)) / (2 * math.log(theta))
    lo = max(math.floor(corr(s["beta_fast"])), 0)
    hi = min(math.ceil(corr(s["beta_slow"])), dim - 1)
    if lo == hi:
        hi += 0.001
    i = np.arange(0, dim, 2, dtype=np.float32)
    extra = (1.0 / theta ** (i / dim)).astype(np.float32)
    inter = (1.0 / (factor * theta ** (i / dim))).astype(np.float32)
    ramp = np.clip((np.arange(dim // 2, dtype=np.float32) - lo) / (hi - lo),
                   0, 1).astype(np.float32)
    mask = np.float32(1) - ramp
    return (inter * (1 - mask) + extra * mask).astype(np.float32)


def rope_mscale(scaling=()) -> float:
    """The factor on cos and sin: YaRN's mscale over its mscale_all_dim (1
    for DeepSeek-V2, where both are 0.707; 1 without scaling)."""
    if not scaling:
        return 1.0
    s = dict(scaling)
    f = float(s["factor"])
    return (yarn_mscale(f, s.get("mscale", 1.0))
            / yarn_mscale(f, s.get("mscale_all_dim", 0.0)))


def apply_rope(x, positions, theta: float, scaling=()):
    """x: (..., S, H, Dh); positions broadcastable to (..., S).  Half-split
    layout: the first and second halves of Dh form the rotated pairs.
    ``scaling``: a config's ``rope_scaling`` (YaRN's frequencies and factor
    on cos and sin)."""
    inv_freq = torch.from_numpy(rope_frequencies(x.shape[-1], theta,
                                                 scaling)).to(x.device)
    tracing.count(tracing.HOST_SYNCS)       # a pageable copy: it waits
    ang = positions[..., None].float() * inv_freq
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    mult = rope_mscale(scaling)
    if mult != 1.0:
        sin, cos = sin * mult, cos * mult
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
