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


def decode_attention_split_plain(q, cache_k, cache_v, pos, *, ring=False,
                                 split=64):
    """The split kernel and the combine kernel of `kernel.cu`, step for
    step, in plain torch (for tests): the cache is cut into spans of
    ``split`` rows; each span yields a partial (m, l, acc) over its rows in
    the slot's valid prefix [0, min(pos + 1, S)) with the mask formula of
    `decode_attention_reference`, or an empty one (m = -inf, l = 0); the
    partials merge in span order by the log-sum-exp rule, skipping empty
    ones, and a slot with no valid key gives 0."""
    B, H, hd = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    n_split = -(-S // split)
    pad = n_split * split - S
    ck = torch.nn.functional.pad(cache_k.float(), (0, 0, 0, 0, 0, pad))
    cv = torch.nn.functional.pad(cache_v.float(), (0, 0, 0, 0, 0, pad))
    ck = ck.reshape(B, n_split, split, KV, hd)
    cv = cv.reshape(B, n_split, split, KV, hd)
    qs = q.reshape(B, KV, G, hd).float() * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bkgd,bjrkd->bkgjr", qs, ck)
    s_idx = torch.arange(n_split * split, device=q.device)[None, :]
    pb = pos.to(device=q.device, dtype=torch.int64)[:, None]
    live = s_idx < (pb + 1).clamp(0, S)
    if ring:
        valid = live & (pb - torch.remainder(pb - s_idx, S) >= 0)
    else:
        valid = live & (s_idx <= pb)
    valid = valid.reshape(B, 1, 1, n_split, split)
    scores = torch.where(valid, scores, torch.full_like(scores,
                                                        float("-inf")))
    m = scores.amax(-1)                                   # (B, KV, G, J)
    empty = m == float("-inf")
    p = torch.where(valid, torch.exp(scores - torch.where(
        empty, torch.zeros_like(m), m)[..., None]), torch.zeros_like(scores))
    l = p.sum(-1)
    acc = torch.einsum("bkgjr,bjrkd->bkgjd", p, cv)
    mx = m.amax(-1, keepdim=True)
    w = torch.where(empty, torch.zeros_like(m),
                    torch.exp(m - torch.where(empty, torch.zeros_like(m),
                                              mx)))
    den = (w * l).sum(-1)
    num = (w[..., None] * acc).sum(-2)
    out = torch.where(den[..., None] > 0, num / torch.where(
        den > 0, den, torch.ones_like(den))[..., None], torch.zeros_like(num))
    return out.reshape(B, H, hd).to(q.dtype)
