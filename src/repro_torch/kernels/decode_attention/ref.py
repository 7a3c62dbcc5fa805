"""Plain-torch single-token attention over a KV cache with per-slot
positions (the twin of `repro.kernels.decode_attention.ref` with the (B,)
position vector of `repro.models.attention.gqa_decode`)."""
from __future__ import annotations

import math

import torch


def decode_attention_reference(q, cache_k, cache_v, pos, *, ring=False):
    """q: (B, H, hd); cache_k/v: (B, S, KV, hd); pos: (B,) int positions.
    ring=True: the cache is a ring buffer (slot = position mod S).  A slot
    with no valid key gives 0."""
    B, H, hd = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg,
                          cache_k.float()) / math.sqrt(hd)
    s_idx = torch.arange(S, device=q.device)[None, :]
    pb = pos.to(device=q.device, dtype=torch.int64)[:, None]
    if ring:
        valid = pb - torch.remainder(pb - s_idx, S) >= 0   # floor modulo
    else:
        valid = s_idx <= pb
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).nan_to_num(0.0)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cache_v.float())
    return out.reshape(B, H, hd).to(q.dtype)
