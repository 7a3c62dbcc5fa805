"""Linear routers of the port (mirrors `repro.core.routers.linear`, §5,
C.2).

Utility: per-model ridge regression over embeddings, in closed form on the
host (numpy, the reference's arithmetic, so the weights are bit-equal);
``predict_utility`` is one product on the device.  Selection: multinomial
logistic regression trained with AdamW (`nn_utils.train`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..dataset import RoutingDataset
from .base import Router, gold_labels
from .spec import register
from . import nn_utils as nn


def _ridge(X, Y, reg=1e-2):
    """X: (N, D); Y: (N, M) -> (W (D+1, M)) with bias row appended."""
    Xb = np.concatenate([X, np.ones((len(X), 1), np.float32)], axis=1)
    A = Xb.T @ Xb + reg * np.eye(Xb.shape[1], dtype=np.float32)
    B = Xb.T @ Y
    return np.linalg.solve(A, B).astype(np.float32)


@register("linear", paper_rank=1)
class LinearRouter(Router):
    name = "Linear"
    state_attrs = ("_Ws", "_Wc", "_sel_params", "_sel_lam")

    def __init__(self, reg: float = 1e-2, device: str = "cuda"):
        self.reg = reg
        self.device = torch.device(device)

    def fit(self, ds: RoutingDataset, seed: int = 0):
        self._record_fit(ds, seed)
        X, S, C = ds.part("train")
        self._Ws = _ridge(X, S, self.reg)
        self._Wc = _ridge(X, C, self.reg)
        return self

    @torch.no_grad()
    def predict_utility(self, X: np.ndarray):
        x = nn.inputs(X, self.device)
        Xb = torch.cat([x, torch.ones((len(x), 1), device=self.device)], 1)
        s = Xb @ self._dev_of("_Ws")
        c = Xb @ self._dev_of("_Wc")
        return s.cpu().numpy(), c.cpu().numpy()

    # ---- selection: multinomial logistic regression ----
    def _sel_init(self, gen, D, M):
        return nn.linear_init(gen, D, M)

    def fit_selection(self, ds: RoutingDataset, lam: float, seed: int = 0):
        self._record_fit(ds, seed)
        self._sel_lam = lam
        X, S, C = ds.part("train")
        y = gold_labels(S, C, lam)
        params = self._sel_init(torch.Generator().manual_seed(seed),
                                X.shape[1], ds.n_models)

        def loss_fn(p, batch):
            return nn.ce_loss(nn.linear(p, batch["x"]), batch["y"])

        self._sel_params, self.train_losses = nn.train(
            params, loss_fn, {"x": X.astype(np.float32), "y": y},
            epochs=60, lr=5e-3, seed=seed, device=self.device)
        return self

    @torch.no_grad()
    def select(self, X: np.ndarray) -> np.ndarray:
        logits = nn.linear(self._sel_params, nn.inputs(X, self.device))
        return logits.argmax(dim=1).cpu().numpy()
