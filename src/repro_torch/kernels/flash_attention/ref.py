"""Plain-torch forward attention (the twin of
`repro.models.attention.attend_ref`, which
`repro.kernels.flash_attention.ref` delegates to): f32 scores and softmax,
GQA by head groups, causal and sliding-window masks, a value head dim that
may differ from the query / key one (MLA's 192 / 128) and a scale of the
caller's (1/sqrt(hd) by default); and its gradient
(`flash_attention_bwd_plain`), the plain version of the backward kernel."""
from __future__ import annotations

import math

import torch


def flash_attention_reference(q, k, v, *, causal=True, window=0, q_offset=0,
                              scale=None):
    """q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B, Sk, KV, dv) ->
    (B, Sq, H, dv) in q.dtype; scores scaled by ``scale`` (default
    1/sqrt(hd))."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    c = 1.0 / math.sqrt(hd) if scale is None else scale
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * c
    if causal or window:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, do, *, causal=True, window=0,
                              scale=None):
    """The gradient of `flash_attention_reference`: autograd through the
    plain forward, as the reference's trainer differentiates `attend_ref`.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_reference(qq, kk, vv, causal=causal,
                                        window=window, scale=scale)
        return torch.autograd.grad(out, (qq, kk, vv), do)
