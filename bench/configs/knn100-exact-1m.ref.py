"""Plain reference of ``knn100-exact-1m``: the query encoder, the exact
cosine top-k over the support and the k-nearest-neighbour decision tail,
in float32 PyTorch (TF32 off), imported by nothing of the port.

- Tokens: each text lower-cased and split on white space, its first 64
  words hashed (the first 8 hex digits of the word's MD5, modulo 8,190,
  plus 2); no word gives the one token 1; 0 pads.
- Encoder: the embedding row of each token, two pre-norm blocks (causal
  attention with half-split RoPE over positions 0-63, SwiGLU), the mean
  over the non-pad positions, scaled to unit length.
- Retrieval: cosine similarity of each unit query with each support row
  (rows scaled to unit length here), the k largest, in blocks of rows.
- Tail (uniform weights): each model's predicted score and cost are the
  mean over the k neighbours; the choice is the first model of largest
  score - lambda x cost; the agreement is the share of neighbours whose
  best-scoring model is the most common such model.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from bench import plain


def tokenize(texts, vocab: int, max_len: int) -> np.ndarray:
    out = np.zeros((len(texts), max_len), np.int64)
    for i, t in enumerate(texts):
        ids = [int(hashlib.md5(w.encode()).hexdigest()[:8], 16) % (vocab - 2)
               + 2 for w in t.lower().split()[:max_len]] or [1]
        out[i, :len(ids)] = ids
    return out


def encoder_specs(e: dict):
    d, H, hd = e["hidden_size"], e["num_attention_heads"], e["head_dim"]
    specs = [("embed", (e["vocab_size"], d), 1.0),
             ("lm_head", (d, e["vocab_size"]), 1 / math.sqrt(d)),
             ("final_norm.scale", (d,), None)]
    for i in range(e["num_hidden_layers"]):
        specs += plain.block_specs(f"blocks.{i}", d, H,
                                   e["num_key_value_heads"], hd,
                                   e["intermediate_size"])
    return specs


def _consts(e):
    return dict(H=e["num_attention_heads"], KV=e["num_key_value_heads"],
                hd=e["head_dim"], eps=e["rms_norm_eps"],
                theta=e["rope_theta"], window=0)


@torch.no_grad()
def embed(w: dict, e: dict, tokens: np.ndarray, device,
          pr: plain.Precision, block: int = 2048) -> torch.Tensor:
    """Unit (n, D) float32 embeddings of token rows, on ``device``."""
    c = _consts(e)
    outs = []
    for i in range(0, len(tokens), block):
        t = torch.from_numpy(tokens[i:i + block]).to(device)
        x = w["embed"][t].float()
        pos = torch.arange(t.shape[1], device=device)[None].expand_as(t)
        for j in range(e["num_hidden_layers"]):
            x = plain.block(x, w, f"blocks.{j}", pos, c, pr)
        m = (t > 0).float()[..., None]
        h = (x * m).sum(1) / m.sum(1).clamp_min(1.0)
        outs.append(h / h.norm(dim=1, keepdim=True).clamp_min(1e-9))
    return torch.cat(outs)


def unit_rows(X: torch.Tensor) -> torch.Tensor:
    return X / X.norm(dim=1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def topk(q: torch.Tensor, X_host: np.ndarray, k: int,
         pr: plain.Precision, block: int = 131072):
    """The k + 1 largest cosine similarities of the unit queries ``q``
    (on the device) over the host support rows, with their row ids."""
    best_s = best_i = None
    for lo in range(0, len(X_host), block):
        xb = unit_rows(torch.from_numpy(X_host[lo:lo + block]).to(q.device))
        s = pr.mm(q, xb.T)
        kk = min(k + 1, s.shape[1])
        vs, vi = torch.topk(s, kk, dim=1)
        vi = vi + lo
        if best_s is not None:
            vs, pos = torch.topk(torch.cat([best_s, vs], 1),
                                 min(k + 1, best_s.shape[1] + kk), dim=1)
            vi = torch.gather(torch.cat([best_i, vi], 1), 1, pos)
        best_s, best_i = vs, vi
    return best_s, best_i


@torch.no_grad()
def tail(idx: torch.Tensor, S: torch.Tensor, C: torch.Tensor,
         lam: torch.Tensor):
    """Uniform-weight decision of the k neighbours ``idx`` (Q, k):
    (choice, s_hat, c_hat, agreement)."""
    s_hat = S[idx].mean(1)
    c_hat = C[idx].mean(1)
    best = S[idx].argmax(2)                                   # (Q, k)
    M = S.shape[1]
    counts = (best[..., None] == torch.arange(M, device=S.device)).sum(1)
    agree = counts.max(1).values.float() / idx.shape[1]
    util = s_hat - lam[:, None] * c_hat
    choice = util.argmax(1)
    return choice, s_hat, c_hat, agree, util
