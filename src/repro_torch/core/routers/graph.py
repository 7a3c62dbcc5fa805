"""Graph router of the port (mirrors `repro.core.routers.graph`, §5,
GraphRouter-style): bipartite query/model graph over the query's
k-nearest support neighbourhood.  Two rounds of message passing: edge
features (observed neighbour scores/costs) -> model nodes -> query node,
then an MLP head predicts the (s, c) of every (query, model) edge.

`NeighbourRouter` holds what this family shares with the attentive ones:
the support set on the device, the neighbour search through the exact
top-k kernel (`knn_topk`, kernel 1 on a CUDA router, its plain version on
a CPU one), the gather of the neighbours' rows on the device, the fit and
the batched prediction.  At fit time the train split queries itself and
drops each row's first neighbour, itself (``exclude_self``), as the
reference does: that is right where a row's top-1 is the row itself,
which a near-duplicate row can break in either package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.knn_topk.ops import knn_topk
from ..dataset import RoutingDataset
from .base import Router, normalize_rows
from .spec import register
from . import nn_utils as nn


class NeighbourRouter(Router):
    """A learned router over each query's k support neighbours; subclasses
    give ``_init(gen, D, M)`` and ``_forward(p, xq, nb_x, nb_s, nb_c)``."""
    state_attrs = ("_params", "_X", "_Xraw", "_S", "_C", "_c_scale",
                   "_sel_lam")
    #: queries a forward pass of ``predict_utility`` takes at once
    predict_batch = 512

    # ---- neighbour machinery ----
    def _nbrs(self, X, exclude_self=False):
        """Neighbour ids (Q, k) on the device, int64."""
        q = torch.from_numpy(normalize_rows(X)).to(self.device)
        k = min(self.k + (1 if exclude_self else 0), len(self._X))
        _, idx = knn_topk(q, self._dev_of("_X"), k)
        if exclude_self:
            idx = idx[:, 1:]
        return idx.long()

    def _gather(self, idx):
        """The neighbours' raw rows, scores and scaled costs, gathered on
        the device: (Q, k, D), (Q, k, M), (Q, k, M)."""
        return (self._dev_of("_Xraw")[idx], self._dev_of("_S")[idx],
                self._dev_of("_C")[idx])

    def fit(self, ds: RoutingDataset, seed: int = 0):
        self._record_fit(ds, seed)
        X, S, C = ds.part("train")
        self._X = normalize_rows(X)
        self._Xraw = X.astype(np.float32)
        self._S = S.astype(np.float32)
        self._c_scale = max(float(np.abs(C).max()), 1e-9)
        self._C = (C / self._c_scale).astype(np.float32)
        idx = self._nbrs(X, exclude_self=True)
        params = self._init(torch.Generator().manual_seed(seed), ds.dim,
                            ds.n_models)
        data = {"x": self._Xraw, "idx": idx, "s": self._S, "c": self._C}
        self._params, self.train_losses = nn.train(
            params, nn.mse_loss(lambda p, b: self._forward(
                p, b["x"], *self._gather(b["idx"]))), data,
            epochs=self.epochs, lr=self.lr, batch_size=self.batch_size,
            seed=seed, device=self.device)
        return self

    @torch.no_grad()
    def predict_utility(self, X: np.ndarray):
        idx = self._nbrs(X)
        x = nn.inputs(X, self.device)
        outs_s, outs_c = [], []
        for i in range(0, len(x), self.predict_batch):
            sl = slice(i, i + self.predict_batch)
            s, c = self._forward(self._params, x[sl], *self._gather(idx[sl]))
            outs_s.append(s)
            outs_c.append(c)
        return (torch.cat(outs_s).cpu().numpy(),
                torch.cat(outs_c).cpu().numpy() * self._c_scale)


@register("graph", k_param="k", default_ks=(10, 100), paper_rank=5)
class GraphRouter(NeighbourRouter):

    def __init__(self, k: int = 10, hidden: int = 64, epochs: int = 60,
                 lr: float = 2e-3, batch_size: int = 128,
                 device: str = "cuda"):
        self.k, self.hidden = k, hidden
        self.epochs, self.lr, self.batch_size = epochs, lr, batch_size
        self.device = torch.device(device)
        self.name = f"Graph (k={k})"

    def _init(self, gen, D, M):
        h = self.hidden
        return {
            "emb_m": torch.randn((M, h), generator=gen) * 0.1,
            "proj": nn.linear_init(gen, D, h),
            "edge": nn.mlp_params(gen, [h + 2, h, h]),
            "upd_m": nn.mlp_params(gen, [2 * h, h]),
            "upd_q": nn.mlp_params(gen, [2 * h, h]),
            "head": nn.mlp_params(gen, [2 * h, h, 2]),
        }

    @staticmethod
    def _forward(p, xq, nb_x, nb_s, nb_c):
        """xq (Q,D); nb_x (Q,k,D); nb_s/nb_c (Q,k,M) -> (s,c) (Q,M)."""
        Q, k, M = nb_s.shape
        hq = torch.relu(nn.linear(p["proj"], xq))              # (Q,h)
        hn = torch.relu(nn.linear(p["proj"], nb_x))            # (Q,k,h)
        h = hq.shape[-1]
        hn_b = hn[:, :, None, :].expand(Q, k, M, h)
        ef = torch.cat([hn_b, nb_s[..., None], nb_c[..., None]], -1)
        msg = nn.mlp_apply(p["edge"], ef).mean(dim=1)          # (Q,M,h)
        em = p["emb_m"][None].expand(Q, M, h)
        hm = torch.relu(nn.mlp_apply(p["upd_m"], torch.cat([em, msg], -1)))
        hq2 = torch.relu(nn.mlp_apply(
            p["upd_q"], torch.cat([hq, hm.mean(dim=1)], -1)))
        hq_b = hq2[:, None, :].expand(Q, M, h)
        out = nn.mlp_apply(p["head"], torch.cat([hq_b, hm], -1))
        return out[..., 0], out[..., 1]
