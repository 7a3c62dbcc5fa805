"""Mamba-2 (SSD) mixer block (mirrors `repro.models.ssm`): in_proj ->
causal depthwise conv -> SSD -> gated norm -> out_proj.

The full-sequence path (`ssm_full`, training and forward) runs the chunked
SSD scan, whose intra-chunk pass is kernel 6 on the card
(`kernels.ssd_scan.ops.ssd_scan`); the decode path (`ssm_decode`) is the
O(1) recurrence `ssd_decode_step`, in plain ops as in the reference.
``A_log``, ``D`` and ``dt_bias`` stay f32 in a bf16 model, as there."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step
from .layers import RMSNorm, dense_init_, dtype_of, param, rmsnorm


def _dims(cfg):
    d_in = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    G = cfg.ssm_n_groups
    N = cfg.ssm_state
    conv_ch = d_in + 2 * G * N
    return d_in, H, P, G, N, conv_ch


class SSM(nn.Module):
    """Parameters of one mixer, named as the reference's ``ssm`` leaves."""

    def __init__(self, cfg, device):
        super().__init__()
        d = cfg.d_model
        d_in, H, P, G, N, conv_ch = _dims(cfg)
        dt = dtype_of(cfg)
        f32 = torch.float32
        self.in_proj = param((d, 2 * d_in + 2 * G * N + H), dt, device)
        self.conv_w = param((cfg.ssm_conv, conv_ch), dt, device)
        self.conv_b = param((conv_ch,), dt, device, fill=0.0)
        self.A_log = param((H,), f32, device, fill=0.0)   # A = -exp(0) = -1
        self.D = param((H,), f32, device, fill=1.0)
        self.dt_bias = param((H,), f32, device, fill=0.0)
        self.norm = RMSNorm(d_in, dt, device)
        self.out_proj = param((d_in, d), dt, device)

    def init_(self, generator):
        """`ssm_init`: fan-in in/out projections, conv taps at scale 0.5,
        zero conv bias, A_log 0, D 1, dt_bias 0, unit norm."""
        dense_init_(self.in_proj, generator)
        dense_init_(self.conv_w, generator, scale=0.5)
        dense_init_(self.out_proj, generator)
        with torch.no_grad():
            self.conv_b.zero_()
            self.A_log.zero_()
            self.D.fill_(1.0)
            self.dt_bias.zero_()
            self.norm.scale.fill_(1.0)


def _split_proj(cfg, zxbcdt):
    d_in, H, P, G, N, _ = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in: 2 * d_in + 2 * G * N]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * G * N:]
    return z, xBC, dt_raw


def _causal_conv(p: SSM, xBC, state=None):
    """Depthwise causal conv of K taps, as K shifted multiply-adds in the
    reference's order.  xBC: (B, S, C).  Returns (silu(out), new_state)
    where state: (B, K-1, C) holds the trailing inputs."""
    K = p.conv_w.shape[0]
    if state is None:
        pad = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
    else:
        pad = state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                # (B, S+K-1, C)
    S = xBC.shape[1]
    out = xp[:, 0:S] * p.conv_w[0]
    for i in range(1, K):
        out = out + xp[:, i: i + S] * p.conv_w[i]
    out = out + p.conv_b
    return F.silu(out), xp[:, -(K - 1):]


def ssm_full(p: SSM, cfg, x, initial_state=None, return_state=False):
    """x: (B, S, D) -> (B, S, D).  Sequences not divisible by the SSD chunk
    are zero-padded at the tail (causal: earlier outputs unaffected); state
    handoff requires a divisible length."""
    B, S, _ = x.shape
    d_in, H, P, G, N, _ = _dims(cfg)
    z, xBC, dt_raw = _split_proj(cfg, x @ p.in_proj)
    xBC, _ = _causal_conv(p, xBC)
    xs = xBC[..., :d_in].reshape(B, S, H, P)
    Bm = xBC[..., d_in: d_in + G * N].reshape(B, S, G, N)
    Cm = xBC[..., d_in + G * N:].reshape(B, S, G, N)
    dt_v = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    chunk = min(cfg.ssm_chunk, S)
    pad = (-S) % chunk
    xs_in, Bm_in, Cm_in, dt_in = xs, Bm, Cm, dt_v
    if pad:
        assert not return_state, "state handoff needs chunk-divisible length"
        xs_in = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm_in = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm_in = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        dt_in = F.pad(dt_v, (0, 0, 0, pad))
    y, state = ssd_scan(xs_in, dt_in, A, Bm_in, Cm_in, chunk=chunk,
                        initial_state=initial_state)
    if pad:
        y = y[:, :S]
    y = y + p.D[None, None, :, None] * xs.float()
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rmsnorm(p.norm, y * F.silu(z))
    out = y @ p.out_proj
    if return_state:
        return out, state
    return out


def ssm_state_init(cfg, batch, device, dtype=torch.float32):
    """Per-layer decode state: the conv's trailing inputs and the SSD
    state, both zero."""
    d_in, H, P, G, N, conv_ch = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=dtype, device=device),
            "ssd": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=device)}


def ssm_decode(p: SSM, cfg, x, state):
    """x: (B, 1, D); state from `ssm_state_init`.  Returns (y, new_state)
    with new tensors (the caller decides which slots keep them)."""
    B = x.shape[0]
    d_in, H, P, G, N, _ = _dims(cfg)
    z, xBC, dt_raw = _split_proj(cfg, x @ p.in_proj)
    xBC, conv_state = _causal_conv(p, xBC, state["conv"])
    xs = xBC[:, 0, :d_in].reshape(B, H, P)
    Bm = xBC[:, 0, d_in: d_in + G * N].reshape(B, G, N)
    Cm = xBC[:, 0, d_in + G * N:].reshape(B, G, N)
    dt_v = F.softplus(dt_raw[:, 0].float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, ssd_state = ssd_decode_step(state["ssd"], xs, dt_v, A, Bm, Cm)
    y = y + p.D[None, :, None] * xs.float()
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rmsnorm(p.norm, y * F.silu(z))
    return y @ p.out_proj, {"conv": conv_state, "ssd": ssd_state}
