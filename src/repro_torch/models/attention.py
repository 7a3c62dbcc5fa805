"""Grouped-query attention (mirrors `repro.models.attention`'s GQA path):
RoPE, optional qk-norm and bias, sliding window.

`gqa_full` runs the forward attention kernel (`kernels.flash_attention`)
where the reference calls `attend_ref`; `gqa_decode` writes the new K/V row
of every slot into the cache and runs the decode attention kernel
(`kernels.decode_attention`) with the slots' position vector, where the
reference computes the attention inline.  The cache is updated in place
(the reference returns new arrays), which saves a copy of the whole cache
per layer and step."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from .layers import RMSNorm, apply_rope, dense_init_, dtype_of, param, rmsnorm


class GQA(nn.Module):
    def __init__(self, cfg, device, d_model=None):
        super().__init__()
        d = d_model or cfg.d_model
        hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        dt = dtype_of(cfg)
        self.wq = param((d, H * hd), dt, device)
        self.wk = param((d, KV * hd), dt, device)
        self.wv = param((d, KV * hd), dt, device)
        self.wo = param((H * hd, d), dt, device)
        if cfg.qkv_bias:
            self.bq = param((H * hd,), dt, device, fill=0.0)
            self.bk = param((KV * hd,), dt, device, fill=0.0)
            self.bv = param((KV * hd,), dt, device, fill=0.0)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, dt, device)
            self.k_norm = RMSNorm(hd, dt, device)

    def init_(self, generator):
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)


def _project_qkv(p: GQA, cfg, x, positions):
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, -1, H, hd)
    k = k.reshape(B, -1, KV, hd)
    v = v.reshape(B, -1, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q)
        k = rmsnorm(p.k_norm, k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_full(p: GQA, cfg, x, positions, *, causal=True, window=None):
    """Full-sequence self-attention.  x: (B, S, D); positions: (B, S)."""
    w = cfg.sliding_window if window is None else window
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = flash_attention(q, k, v.contiguous(), causal=causal, window=w)
    B, S = x.shape[0], out.shape[1]
    return out.reshape(B, S, -1) @ p.wo


def gqa_decode(p: GQA, cfg, x, cache_k, cache_v, pos, *, window=0):
    """Single-token decode.  x: (B, 1, D); cache: (B, S, KV, hd); pos: (B,)
    int positions.  With ``window > 0`` the cache is a ring buffer and the
    new row lands at slot ``pos % S``; otherwise at ``pos`` (clamped to the
    cache, as `dynamic_update_slice` clamps).  Returns (y, cache_k,
    cache_v); the caches are the same tensors, updated in place."""
    B = x.shape[0]
    pos = pos.to(device=x.device, dtype=torch.int32)
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    S = cache_k.shape[1]
    slot = pos % max(S, 1) if window > 0 else pos.clamp(0, S - 1)
    rows = torch.arange(B, device=x.device)
    cache_k[rows, slot] = k[:, 0]
    cache_v[rows, slot] = v[:, 0]
    out = decode_attention(q[:, 0].contiguous(), cache_k, cache_v, pos,
                           ring=window > 0)
    y = out.reshape(B, -1).to(x.dtype) @ p.wo
    return y[:, None, :], cache_k, cache_v
