"""Attention (mirrors `repro.models.attention`): grouped-query attention
with RoPE, optional qk-norm and bias and a sliding window, and DeepSeek-V2's
multi-head latent attention (MLA).

`gqa_full` runs the forward attention kernel (`kernels.flash_attention`)
where the reference calls `attend_ref`: self-attention (causal, windowed,
or full for the encoder) and, with ``kv_x``, cross attention from the
decoder's queries to the encoder's output (non-causal, Sq != Sk, no
RoPE).  `gqa_decode` writes the new K/V row of every slot into the cache
and runs the decode attention kernel (`kernels.decode_attention`) with
the slots' position vector, where the reference computes the attention
inline.  The cache is updated in place (the reference returns new
arrays), which saves a copy of the whole cache per layer and step.
`gqa_cross_decode` runs the same decode kernel over the cached cross K/V
of `cross_kv`, every slot at position Se - 1: the reference's softmax
over the whole encoder output.

MLA is jnp in the reference; here `mla_full` runs the same forward
attention kernel on [q_nope, q_rope] against [k_nope, k_rope broadcast
over the heads], its qk dim (nope + rope, 192 at full width) apart from
its v dim (128), with the softmax scale of `mla_scale` (YaRN's mscale^2 /
sqrt(192) where the config's ``rope_scaling`` asks for it); f32 on the
card keeps the einsum attention (the kernels' (192, 128) pair is bf16).
`mla_decode` is the absorbed decode over the
latent cache (B, S, kv_lora_rank) + (B, S, qk_rope_dim);
``cfg.mla_naive_decode`` selects `mla_decode_naive`, which expands the
whole latent cache to per-head K / V every step.

On a sharded model (`launch.shardings.shard_lm`, `distributed.tp`) the
kernels run on each rank's own heads (`tp.attend`), and decode runs over
the reference's sequence-sharded caches (`cache_placements`: S over
"model"): each rank attends over its own cache rows, the decode kernel
also returning its log-sum-exp, and the ranks' partials are merged by it
(`tp.decode_merge`, flash-decoding); MLA's absorbed decode does the same
in torch ops."""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch import tracing
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.distributed import tp
from .layers import (RMSNorm, apply_rope, dense_init_, dtype_of, param,
                     rmsnorm, yarn_mscale)


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


def _project_qkv(p: GQA, cfg, x, positions, kv_x=None):
    """q from ``x``, k and v from ``kv_x`` (cross attention) or ``x``; with
    ``kv_x`` neither q nor k is rotated, as in the reference."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    q, k, v = x @ p.wq, src @ p.wk, src @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = tp.split_heads(q, H, hd)
    k = tp.split_heads(k, KV, hd)
    v = tp.split_heads(v, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q)
        k = rmsnorm(p.k_norm, k)
    if kv_x is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_full(p: GQA, cfg, x, positions, *, causal=True, window=None,
             kv_x=None):
    """Full-sequence attention.  x: (B, S, D); positions: (B, S).  With
    ``kv_x`` (B, Se, D) it is cross attention: keys and values from
    ``kv_x``, no mask (``causal`` is ignored), no RoPE."""
    w = cfg.sliding_window if window is None else window
    q, k, v = _project_qkv(p, cfg, x, positions, kv_x=kv_x)
    out = tp.attend(flash_attention, q, k, v,
                    causal=causal and kv_x is None, window=w)
    return tp.merge_heads(out) @ p.wo


def gqa_decode(p: GQA, cfg, x, cache_k, cache_v, pos, *, window=0):
    """Single-token decode.  x: (B, 1, D); cache: (B, S, KV, hd); pos: (B,)
    int positions.  With ``window > 0`` the cache is a ring buffer and the
    new row lands at slot ``pos % S``; otherwise at ``pos`` (clamped to the
    cache, as `dynamic_update_slice` clamps).  Returns (y, cache_k,
    cache_v); the caches are the same tensors, updated in place."""
    B = x.shape[0]
    pos = pos.to(device=x.device, dtype=torch.int32)
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    mesh = tp.mesh_of(p.wq)
    rows = torch.arange(B, device=x.device)
    S = cache_k.shape[1] * (1 if mesh is None else mesh.size())
    slot = pos % max(S, 1) if window > 0 else pos.clamp(0, S - 1)
    if mesh is not None:
        q, k, v = (tp.full(t) for t in (q, k, v))
        tp.write_row(cache_k, rows, slot, k[:, 0], mesh)
        tp.write_row(cache_v, rows, slot, v[:, 0], mesh)
        out = _decode_sharded(q[:, 0], cache_k, cache_v, pos, mesh)
    else:
        cache_k[rows, slot] = k[:, 0]
        cache_v[rows, slot] = v[:, 0]
        out = decode_attention(q[:, 0].contiguous(), cache_k, cache_v, pos,
                               ring=window > 0)
    y = out.reshape(B, -1).to(x.dtype) @ p.wo
    return y[:, None, :], cache_k, cache_v


def _decode_sharded(q, cache_k, cache_v, pos, mesh):
    """Decode attention of q (B, H, hd), every head, over a sequence-sharded
    cache: this rank's rows through the kernel (its valid prefix,
    `tp.seq_rows`), the ranks' partials merged by their log-sum-exp."""
    last = tp.seq_rows(pos, cache_k.shape[1], mesh)
    out, lse = decode_attention(q.contiguous(), cache_k, cache_v, last,
                                ring=False, return_lse=True)
    return tp.decode_merge(out, lse, mesh)


def cross_kv(p: GQA, cfg, enc_out):
    """The cross attention's K / V of the encoder output, (B, Se, KV, hd)
    each, projected once a request (`model.fill_cross_cache`).  As in the
    reference, no ``k_norm`` here, unlike `gqa_full` with ``kv_x``: no
    config combines qk-norm with cross attention."""
    B, Se, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    k, v = enc_out @ p.wk, enc_out @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return k.reshape(B, Se, KV, hd), v.reshape(B, Se, KV, hd)


def gqa_cross_decode(p: GQA, cfg, x, ck, cv):
    """Single-token cross attention against the cached encoder K / V.
    x: (B, 1, D); ck / cv: (B, Se, KV, hd).  The decode kernel with every
    slot at position Se - 1 attends to all Se rows."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = tp.split_heads(q, H, hd)[:, 0]
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q)
    mesh = tp.mesh_of(p.wq)
    Se = ck.shape[1] * (1 if mesh is None else mesh.size())
    last = torch.full((B,), Se - 1, dtype=torch.int32, device=x.device)
    if mesh is not None:
        out = _decode_sharded(tp.full(q), ck, cv, last, mesh)
    else:
        out = decode_attention(q.contiguous(), ck, cv, last, ring=False)
    y = out.reshape(B, -1).to(x.dtype) @ p.wo
    return y[:, None, :]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """Parameters of one MLA layer, named as the reference's leaves."""

    def __init__(self, cfg, device):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        dt = dtype_of(cfg)
        self.w_dkv = param((d, r + rd), dt, device)
        self.kv_norm = RMSNorm(r, dt, device)
        self.w_uk = param((r, H * nd), dt, device)
        self.w_uv = param((r, H * vd), dt, device)
        self.wo = param((H * vd, d), dt, device)
        if qr:
            self.w_dq = param((d, qr), dt, device)
            self.q_norm = RMSNorm(qr, dt, device)
            self.w_uq = param((qr, H * (nd + rd)), dt, device)
        else:
            self.wq = param((d, H * (nd + rd)), dt, device)

    def init_(self, generator):
        for name in ("w_dkv", "w_uk", "w_uv", "wo", "w_dq", "w_uq", "wq"):
            if hasattr(self, name):
                dense_init_(getattr(self, name), generator)


def _mla_q(p: MLA, cfg, x, positions):
    B, S, _ = x.shape
    H, nd, rd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = rmsnorm(p.q_norm, x @ p.w_dq) @ p.w_uq
    else:
        q = x @ p.wq
    q = tp.split_heads(q, H, nd + rd)
    return q[..., :nd], apply_rope(q[..., nd:], positions, cfg.rope_theta,
                                   cfg.rope_scaling)


def _mla_ckv(p: MLA, cfg, x, positions):
    ckv = x @ p.w_dkv
    r = cfg.kv_lora_rank
    c = rmsnorm(p.kv_norm, ckv[..., :r])
    k_rope = apply_rope(ckv[..., None, r:], positions, cfg.rope_theta,
                        cfg.rope_scaling)
    return c, k_rope[..., 0, :]


def mla_scale(cfg):
    """The softmax scale 1/sqrt(nope + rope), times YaRN's mscale(factor,
    mscale_all_dim)^2 where ``rope_scaling`` sets mscale_all_dim
    (DeepSeek-V2: 1.2608^2 / sqrt(192) = 0.11472)."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    s = dict(cfg.rope_scaling)
    if s.get("mscale_all_dim"):
        m = yarn_mscale(float(s["factor"]), float(s["mscale_all_dim"]))
        scale *= m * m
    return scale



def _mla_attend(q_nope, q_rope, k_nope, k_rope, v, scale):
    """Causal MLA attention on (B, S, H, d) heads (k_rope (B, S, rd) shared
    by every head); a 1-tuple of (B, S, H, vd).  The forward attention
    kernel on the concatenated heads; f32 on the card the einsum
    attention below (`_mla_attend_f32`)."""
    if q_nope.is_cuda and q_nope.dtype == torch.float32:
        return _mla_attend_f32(q_nope, q_rope, k_nope, k_rope, v, scale)
    H = q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], -1).contiguous()
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        -1, -1, H, -1)], -1).contiguous()
    return (flash_attention(q, k, v.contiguous(), causal=True, scale=scale),)


def _mla_attend_f32(q_nope, q_rope, k_nope, k_rope, v, scale):
    """Causal MLA attention in f32 by einsum (the kernels take no f32
    (192, 128) pair)."""
    S = q_nope.shape[1]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                             k_rope.float())) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q_nope.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return (torch.einsum("bhqk,bkhd->bqhd", probs, v.float()),)


def mla_full(p: MLA, cfg, x, positions):
    """Causal full-sequence MLA.  x: (B, S, D).  On a sharded model each
    rank attends with its own heads (`tp.on_heads`)."""
    H, nd, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c, k_rope = _mla_ckv(p, cfg, x, positions)
    k_nope = tp.split_heads(c @ p.w_uk, H, nd)
    v = tp.split_heads(c @ p.w_uv, H, vd)
    with tracing.span("mla.attend"):
        out, = tp.on_heads(
            lambda *a: _mla_attend(*a, mla_scale(cfg)), H,
            (q_nope, q_rope, k_nope, k_rope, v), in_dims=(2, 2, 2, None, 2),
            out_dims=(2,))
    return tp.merge_heads(out).to(x.dtype) @ p.wo


def _mla_step(p: MLA, cfg, x, cache_c, cache_kr, pos):
    """The new token's queries and latent row, written into the caches at
    ``pos`` (clamped, as `dynamic_update_slice` clamps; on a sharded model
    into the rank that holds that row).  Returns (q_nope, q_rope,
    valid (B, S_local))."""
    B = x.shape[0]
    pos = pos.to(device=x.device, dtype=torch.int32)
    positions = pos[:, None]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c, k_rope = _mla_ckv(p, cfg, x, positions)
    rows = torch.arange(B, device=x.device)
    S = cache_c.shape[1]
    mesh = tp.mesh_of(p.w_dkv)
    if mesh is not None:
        c, k_rope = tp.full(c), tp.full(k_rope)
        slot = pos.clamp(0, S * mesh.size() - 1)
        tp.write_row(cache_c, rows, slot, c[:, 0], mesh)
        tp.write_row(cache_kr, rows, slot, k_rope[:, 0], mesh)
        last = tp.seq_rows(pos, S, mesh)
    else:
        last = pos
        slot = pos.clamp(0, S - 1)
        cache_c[rows, slot] = c[:, 0]
        cache_kr[rows, slot] = k_rope[:, 0]
    valid = torch.arange(S, device=x.device)[None, :] <= last[:, None]
    return q_nope[:, 0].float(), q_rope[:, 0].float(), valid


def _softmax_valid(scores, valid):
    return torch.softmax(scores.masked_fill(~valid[:, None, :],
                                            float("-inf")), dim=-1)


def _attend_rows(scores, valid, values, mesh):
    """softmax(scores) @ values over the valid cache rows: scores (B, H, S)
    f32, values (B, S, d) or (B, S, H, d).  On a sequence-sharded cache
    (``mesh``) each rank's rows give a partial and its log-sum-exp, which
    `tp.decode_merge` merges over the ranks."""
    eq = "bhs,bsd->bhd" if values.ndim == 3 else "bhs,bshd->bhd"
    if mesh is None:
        return torch.einsum(eq, _softmax_valid(scores, valid), values)
    masked = scores.masked_fill(~valid[:, None, :], float("-inf"))
    lse = torch.logsumexp(masked, dim=-1)
    probs = torch.softmax(masked, dim=-1).nan_to_num(0.0)
    return tp.decode_merge(torch.einsum(eq, probs, values), lse, mesh)


def mla_decode_naive(p: MLA, cfg, x, cache_c, cache_kr, pos):
    """Naive MLA decode: the whole latent cache expanded to per-head K / V
    each step.  Caches updated in place; returns (y, cache_c, cache_kr)."""
    B = x.shape[0]
    H, nd, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    q_nope, q_rope, valid = _mla_step(p, cfg, x, cache_c, cache_kr, pos)
    mesh = tp.mesh_of(p.w_dkv)
    q_nope, q_rope = tp.full(q_nope), tp.full(q_rope)
    S = cache_c.shape[1]
    k_nope = (cache_c @ tp.full(p.w_uk)).reshape(B, S, H, nd)
    v = (cache_c @ tp.full(p.w_uv)).reshape(B, S, H, vd)
    scores = (torch.einsum("bhd,bshd->bhs", q_nope, k_nope.float())
              + torch.einsum("bhd,bsd->bhs", q_rope, cache_kr.float())
              ) * mla_scale(cfg)
    out = _attend_rows(scores, valid, v.float(), mesh)
    y = out.reshape(B, -1).to(x.dtype) @ p.wo
    return y[:, None, :], cache_c, cache_kr


def mla_decode(p: MLA, cfg, x, cache_c, cache_kr, pos):
    """Absorbed MLA decode: attention runs in the kv_lora space, so the
    cache is only (B, S, r + rope_dim).  x: (B, 1, D); pos: (B,) int.
    Caches updated in place; returns (y, cache_c, cache_kr)."""
    if getattr(cfg, "mla_naive_decode", False):
        return mla_decode_naive(p, cfg, x, cache_c, cache_kr, pos)
    B = x.shape[0]
    H, nd, vd, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim,
                    cfg.kv_lora_rank)
    q_nope, q_rope, valid = _mla_step(p, cfg, x, cache_c, cache_kr, pos)
    mesh = tp.mesh_of(p.w_dkv)
    # a sharded model: the rank's heads, then every head for its cache rows
    q_abs, = tp.on_heads(lambda q, w: (torch.einsum("bhd,rhd->bhr", q,
                                                    w.float()),), H,
                         (q_nope, tp.split_heads(p.w_uk, H, nd)),
                         in_dims=(1, 1), out_dims=(1,))
    cf = cache_c.float()
    scores = (torch.einsum("bhr,bsr->bhs", tp.full(q_abs), cf)
              + torch.einsum("bhd,bsd->bhs", tp.full(q_rope),
                             cache_kr.float())) * mla_scale(cfg)
    out_c = _attend_rows(scores, valid, cf, mesh)
    out, = tp.on_heads(lambda o, w: (torch.einsum("bhr,rhv->bhv", o,
                                                  w.float()),), H,
                       (tp.replicated_like(out_c, mesh),
                        tp.split_heads(p.w_uv, H, vd)),
                       in_dims=(1, 1), out_dims=(1,))
    y = out.reshape(B, -1).to(x.dtype) @ p.wo
    return y[:, None, :], cache_c, cache_kr
