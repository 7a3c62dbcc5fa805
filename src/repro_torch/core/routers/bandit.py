"""Contextual-bandit router (beyond the paper's evaluated set, completing
its Table-1 taxonomy: MetaLLM / LLMBandit row).

LinUCB with disjoint linear models per arm (model): the router learns ONLINE
from observed utility of the model it actually routed to — no full (x, m)
score matrix needed, which is the realistic deployment regime the bandit
papers target.  Offline interfaces (fit/predict_utility) are provided by
replaying the training set as an online stream, so it plugs into the same
AUC evaluation as every other router.

A numpy copy of the JAX package's `repro.core.routers.bandit` (sequential
rank-1 updates on the host, bit-equal to the reference); ``device`` is
accepted so every family constructs alike, and names no computation.
"""
from __future__ import annotations

import numpy as np

from ..dataset import RoutingDataset
from .base import Router
from .spec import register


@register("linucb")
class LinUCBRouter(Router):
    name = "LinUCB"
    state_attrs = ("_proj", "_A_inv", "_b", "_b_cost", "_c_scale", "_sel_lam")

    def __init__(self, alpha: float = 0.5, ridge: float = 1.0,
                 lam: float = 0.0, replay_epochs: int = 1,
                 feature_dim: int = 64, device: str = "cuda"):
        self.device = device
        self.alpha = alpha          # exploration width
        self.ridge = ridge
        self.lam = lam              # utility trade-off used for the reward
        self.replay_epochs = replay_epochs
        self.feature_dim = feature_dim

    # ---- feature compression (keeps the per-arm inverse cheap) ----
    def _feats(self, X):
        return X @ self._proj

    def _init_arms(self, D, M):
        self._A_inv = np.stack([np.eye(D) / self.ridge for _ in range(M)])
        self._b = np.zeros((M, D), np.float32)
        self._b_cost = np.zeros((M, D), np.float32)

    def _update_arm(self, m, x, reward, cost):
        # Sherman-Morrison rank-1 update of A_inv
        Ai = self._A_inv[m]
        Aix = Ai @ x
        denom = 1.0 + float(x @ Aix)
        self._A_inv[m] = Ai - np.outer(Aix, Aix) / denom
        self._b[m] += reward * x
        self._b_cost[m] += cost * x

    def fit(self, ds: RoutingDataset, seed: int = 0):
        self._record_fit(ds, seed)
        rng = np.random.default_rng(seed)
        X, S, C = ds.part("train")
        D = min(self.feature_dim, X.shape[1])
        pr = rng.normal(size=(X.shape[1], D)).astype(np.float32)
        self._proj = pr / np.sqrt(X.shape[1])
        F = self._feats(X.astype(np.float32))
        M = ds.n_models
        self._init_arms(D, M)
        self._c_scale = max(float(np.abs(C).max()), 1e-9)
        Cn = C / self._c_scale
        for _ in range(self.replay_epochs):
            order = rng.permutation(len(F))
            for i in order:
                x = F[i]
                theta = np.einsum("mde,me->md", self._A_inv, self._b)
                mu = theta @ x
                width = self.alpha * np.sqrt(
                    np.einsum("d,mde,e->m", x, self._A_inv, x))
                arm = int(np.argmax(mu + width
                                    - self.lam * (Cn[i] * 0)))  # cost via obs
                self._update_arm(arm, x, float(S[i, arm]), float(Cn[i, arm]))
        return self

    def predict_utility(self, X: np.ndarray):
        F = self._feats(X.astype(np.float32))
        theta = np.einsum("mde,me->md", self._A_inv, self._b)
        theta_c = np.einsum("mde,me->md", self._A_inv, self._b_cost)
        s_hat = F @ theta.T
        c_hat = (F @ theta_c.T) * self._c_scale
        return s_hat, c_hat

    # online regret accounting for the adaptation benchmark
    def online_replay(self, ds: RoutingDataset, seed: int = 0):
        """Routes the test stream online, updating after each decision.
        Returns per-step achieved score (for cumulative-regret curves)."""
        rng = np.random.default_rng(seed)
        X, S, C = ds.part("test")
        F = self._feats(X.astype(np.float32))
        achieved = []
        for i in range(len(F)):
            x = F[i]
            theta = np.einsum("mde,me->md", self._A_inv, self._b)
            mu = theta @ x
            width = self.alpha * np.sqrt(
                np.einsum("d,mde,e->m", x, self._A_inv, x))
            arm = int(np.argmax(mu + width))
            achieved.append(float(S[i, arm]))
            self._update_arm(arm, x, float(S[i, arm]),
                             float(C[i, arm] / self._c_scale))
        return np.array(achieved)
