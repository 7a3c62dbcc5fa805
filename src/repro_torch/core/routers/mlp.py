"""MLP router of the port (mirrors `repro.core.routers.mlp`, C.2): 3 FC
layers, hidden width 100, ReLU; two heads emit the per-model score and cost
vectors (shared trunk with per-model output units — parameter-equivalent to
the paper's per-model heads).  Selection trains a cross-entropy head over
the gold labels."""
from __future__ import annotations

import numpy as np
import torch

from ..dataset import RoutingDataset
from .base import Router, gold_labels
from .spec import register
from . import nn_utils as nn


@register("mlp", paper_rank=3)
class MLPRouter(Router):
    name = "MLP"
    state_attrs = ("_params", "_c_scale", "_sel_params", "_sel_lam")

    def __init__(self, hidden: int = 100, epochs: int = 120, lr: float = 2e-3,
                 device: str = "cuda"):
        self.hidden, self.epochs, self.lr = hidden, epochs, lr
        self.device = torch.device(device)

    def _init(self, gen, D, M):
        dims = [D, self.hidden, self.hidden, M]
        return {"mlp_s": nn.mlp_params(gen, dims),
                "mlp_c": nn.mlp_params(gen, dims)}

    @staticmethod
    def _predict(p, x):
        return nn.mlp_apply(p["mlp_s"], x), nn.mlp_apply(p["mlp_c"], x)

    def fit(self, ds: RoutingDataset, seed: int = 0):
        self._record_fit(ds, seed)
        X, S, C = ds.part("train")
        params = self._init(torch.Generator().manual_seed(seed), ds.dim,
                            ds.n_models)
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

    # ---- selection ----
    def _sel_init(self, gen, D, M):
        return {"mlp": nn.mlp_params(gen, [D, self.hidden, self.hidden, M])}

    def fit_selection(self, ds: RoutingDataset, lam: float, seed: int = 0):
        self._record_fit(ds, seed)
        self._sel_lam = lam
        X, S, C = ds.part("train")
        y = gold_labels(S, C, lam)
        params = self._sel_init(torch.Generator().manual_seed(seed), ds.dim,
                                ds.n_models)

        def loss_fn(p, b):
            return nn.ce_loss(nn.mlp_apply(p["mlp"], b["x"]), b["y"])

        self._sel_params, self.train_losses = nn.train(
            params, loss_fn, {"x": X, "y": y}, epochs=60, lr=3e-3, seed=seed,
            device=self.device)
        return self

    @torch.no_grad()
    def select(self, X: np.ndarray) -> np.ndarray:
        logits = nn.mlp_apply(self._sel_params["mlp"],
                              nn.inputs(X, self.device))
        return logits.argmax(dim=1).cpu().numpy()
