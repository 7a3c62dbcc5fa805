"""Routing dataset container (a copy of `repro.core.dataset`, numpy only):
(query embedding, per-model score, per-model cost) rows with the paper's
70/10/20 split protocol (Appendix B.4)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class RoutingDataset:
    name: str
    embeddings: np.ndarray          # (N, D) float32
    scores: np.ndarray              # (N, M) in [0, 1]
    costs: np.ndarray               # (N, M) dollars (or any consistent unit)
    model_names: List[str]
    train_idx: np.ndarray = field(default=None)
    val_idx: np.ndarray = field(default=None)
    test_idx: np.ndarray = field(default=None)

    def __post_init__(self):
        n = len(self.embeddings)
        assert self.scores.shape == (n, self.n_models)
        assert self.costs.shape == (n, self.n_models)
        if self.train_idx is None:
            self.split(seed=0)

    # ---- basics ----
    @property
    def n_models(self) -> int:
        return len(self.model_names)

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    def split(self, seed: int = 0, train=0.7, val=0.1):
        """Random 70/10/20 prompt split (paper B.4)."""
        rng = np.random.default_rng(seed)
        n = len(self.embeddings)
        perm = rng.permutation(n)
        n_tr = int(train * n)
        n_va = int(val * n)
        self.train_idx = np.sort(perm[:n_tr])
        self.val_idx = np.sort(perm[n_tr:n_tr + n_va])
        self.test_idx = np.sort(perm[n_tr + n_va:])
        return self

    def subset(self, idx) -> "RoutingDataset":
        ds = RoutingDataset(self.name, self.embeddings[idx], self.scores[idx],
                            self.costs[idx], self.model_names)
        return ds

    def part(self, which: str):
        idx = {"train": self.train_idx, "val": self.val_idx,
               "test": self.test_idx, "all": np.arange(len(self.embeddings))}[which]
        return (self.embeddings[idx], self.scores[idx], self.costs[idx])

    def normalized_embeddings(self, which: str = "all"):
        X = self.part(which)[0] if which != "all" else self.embeddings
        n = np.linalg.norm(X, axis=1, keepdims=True)
        return (X / np.maximum(n, 1e-12)).astype(np.float32)

    @property
    def c_max(self) -> float:
        """Maximum cost observed in the benchmark (used to normalize the
        selection-eval trade-off parameter, §4.3)."""
        return float(self.costs.max())

    def with_ood_test(self, other: "RoutingDataset") -> "RoutingDataset":
        """Train on self, test on `other` (cross-dataset OOD protocol §H)."""
        assert self.model_names == other.model_names
        emb = np.concatenate([self.embeddings, other.embeddings])
        sc = np.concatenate([self.scores, other.scores])
        co = np.concatenate([self.costs, other.costs])
        n0 = len(self.embeddings)
        ds = RoutingDataset(f"{self.name}->{other.name}", emb, sc, co,
                            self.model_names,
                            train_idx=self.train_idx.copy(),
                            val_idx=self.val_idx.copy(),
                            test_idx=n0 + np.arange(len(other.embeddings)))
        return ds
