"""Attentive routers of the port (mirrors `repro.core.routers.attentive`,
§5, C.2): Conditional-Neural-Process style.

AttentiveRouter: per model, self-attention over the k-neighbour support set
(prompt-embedding + score + cost tokens) followed by cross-attention from the
target prompt; MLP heads predict (s, c).

DoubleAttentiveRouter: additionally attends across the model axis so the
representation captures cross-model structure (support is a
(models x examples) tensor processed by two sequential attentions).

Neighbours, their gather and the fit are `graph.NeighbourRouter`'s.
"""
from __future__ import annotations

import torch

from .graph import NeighbourRouter
from .spec import register
from . import nn_utils as nn


@register("attn", k_param="k", default_ks=(10, 100), paper_rank=6)
class AttentiveRouter(NeighbourRouter):
    double = False
    predict_batch = 256

    def __init__(self, k: int = 10, hidden: int = 64, n_heads: int = 4,
                 d_head: int = 32, epochs: int = 40, lr: float = 2e-3,
                 batch_size: int = 128, device: str = "cuda"):
        self.k, self.hidden = k, hidden
        self.n_heads, self.d_head = n_heads, d_head
        self.epochs, self.lr, self.batch_size = epochs, lr, batch_size
        self.device = torch.device(device)
        self.name = ("D-Attn" if self.double else "Attn") + f" (k={k})"

    def _init(self, gen, D, M):
        h = self.hidden
        p = {
            "tok_in": nn.mlp_params(gen, [D + 2, h, h]),
            "q_proj": nn.linear_init(gen, D, h),
            "self_attn": nn.mha_init(gen, h, self.n_heads, self.d_head),
            "cross_attn": nn.mha_init(gen, h, self.n_heads, self.d_head),
            "head_s": nn.mlp_params(gen, [h, h, 1]),
            "head_c": nn.mlp_params(gen, [h, h, 1]),
        }
        if self.double:
            p["model_attn"] = nn.mha_init(gen, h, self.n_heads, self.d_head)
        return p

    def _forward(self, p, xq, nb_x, nb_s, nb_c):
        """xq (Q,D); nb_x (Q,k,D); nb_s/nb_c (Q,k,M) -> (s, c) (Q,M)."""
        Q, k, M = nb_s.shape
        # tokens per (query, model, example)
        nx = nb_x[:, None].expand(Q, M, k, nb_x.shape[-1])
        toks = torch.cat([nx, nb_s.transpose(1, 2)[..., None],
                          nb_c.transpose(1, 2)[..., None]], dim=-1)
        z = nn.mlp_apply(p["tok_in"], toks)                    # (Q,M,k,h)
        z = z + nn.mha(p["self_attn"], z, z, self.n_heads)     # over examples
        if self.double:
            zm = z.transpose(1, 2)                             # (Q,k,M,h)
            zm = zm + nn.mha(p["model_attn"], zm, zm, self.n_heads)  # models
            z = zm.transpose(1, 2)
        q = nn.linear(p["q_proj"], xq)                         # (Q,h)
        qt = q[:, None, None, :].expand(Q, M, 1, q.shape[-1])
        latent = nn.mha(p["cross_attn"], qt, z, self.n_heads)[:, :, 0, :]
        s = nn.mlp_apply(p["head_s"], latent)[..., 0]
        c = nn.mlp_apply(p["head_c"], latent)[..., 0]
        return s, c


@register("dattn", k_param="k", default_ks=(10, 100), paper_rank=7)
class DoubleAttentiveRouter(AttentiveRouter):
    double = True
