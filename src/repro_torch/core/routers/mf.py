"""Matrix-factorization routers of the port (mirrors
`repro.core.routers.mf`, C.2): learnable model embeddings interacting with
the query embedding, linear (RouteLLM-style bilinear) or through an MLP.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dataset import RoutingDataset
from .base import Router
from .spec import register
from . import nn_utils as nn


@register("linear_mf", paper_rank=2)
class LinearMFRouter(Router):
    name = "Linear (MF)"
    state_attrs = ("_params", "_c_scale", "_sel_lam")

    def __init__(self, d_m: int = 128, epochs: int = 120, lr: float = 2e-3,
                 device: str = "cuda"):
        self.d_m, self.epochs, self.lr = d_m, epochs, lr
        self.device = torch.device(device)

    def _init(self, gen, D, M):
        return {
            "emb_m": torch.randn((M, self.d_m), generator=gen) * 0.1,
            "Ws": torch.randn((D, self.d_m), generator=gen) / np.sqrt(D),
            "Wc": torch.randn((D, self.d_m), generator=gen) / np.sqrt(D),
            "bs": torch.zeros((M,)), "bc": torch.zeros((M,)),
        }

    @staticmethod
    def _predict(p, x):
        s = (x @ p["Ws"]) @ p["emb_m"].T + p["bs"]
        c = (x @ p["Wc"]) @ p["emb_m"].T + p["bc"]
        return s, c

    def fit(self, ds: RoutingDataset, seed: int = 0):
        self._record_fit(ds, seed)
        X, S, C = ds.part("train")
        params = self._init(torch.Generator().manual_seed(seed), ds.dim,
                            ds.n_models)
        # scale-balance cost targets (costs can be tiny in absolute $)
        self._c_scale = max(float(np.abs(C).max()), 1e-9)
        Cn = C / self._c_scale
        self._params, self.train_losses = nn.train(
            params, nn.mse_loss(lambda p, b: self._predict(p, b["x"])),
            {"x": X, "s": S, "c": Cn}, epochs=self.epochs, lr=self.lr,
            seed=seed, device=self.device)
        return self

    @torch.no_grad()
    def predict_utility(self, X: np.ndarray):
        s, c = self._predict(self._params, nn.inputs(X, self.device))
        return s.cpu().numpy(), c.cpu().numpy() * self._c_scale


@register("mlp_mf", paper_rank=4)
class MLPMFRouter(LinearMFRouter):
    name = "MLP (MF)"

    def __init__(self, d_m: int = 128, hidden: int = 100, epochs: int = 120,
                 lr: float = 2e-3, device: str = "cuda"):
        super().__init__(d_m=d_m, epochs=epochs, lr=lr, device=device)
        self.hidden = hidden

    def _init(self, gen, D, M):
        head = [2 * self.d_m, self.hidden, self.hidden, 1]
        return {
            "emb_m": torch.randn((M, self.d_m), generator=gen) * 0.1,
            "proj": nn.linear_init(gen, D, self.d_m),
            "mlp_s": nn.mlp_params(gen, head),
            "mlp_c": nn.mlp_params(gen, head),
        }

    @staticmethod
    def _predict(p, x):
        q = nn.linear(p["proj"], x)                       # (Q, dm)
        M = p["emb_m"].shape[0]
        qe = q[:, None, :].expand(q.shape[0], M, q.shape[1])
        me = p["emb_m"][None].expand(q.shape[0], M, p["emb_m"].shape[1])
        z = torch.cat([qe, me], dim=-1)                   # (Q, M, 2dm)
        s = nn.mlp_apply(p["mlp_s"], z)[..., 0]
        c = nn.mlp_apply(p["mlp_c"], z)[..., 0]
        return s, c
