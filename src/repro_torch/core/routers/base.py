"""Router API of the port (mirrors `repro.core.routers.base`): utility
prediction ``predict_utility(X) -> (s_hat, c_hat)``, routing selects
``argmax_m s_hat - lam * c_hat``.  Every fit records ``model_names`` /
``embed_dim`` / ``fit_seed`` so a serving layer can validate arity without
probing, and ``state_dict()`` / ``load_state_dict()`` round-trip every
fitted tensor named in the class's ``state_attrs`` (see `artifacts.py` for
the on-disk format, shared with the reference).  The selection
formulation of the reference is not ported yet."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..dataset import RoutingDataset


def normalize_rows(X: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(X, axis=1, keepdims=True)
    return (X / np.maximum(n, 1e-12)).astype(np.float32)


class Router:
    #: fitted attributes serialized by state_dict(); one declaration per family
    state_attrs: Tuple[str, ...] = ()
    #: spec-level default routing lambda (``@lam=...``); serving fallback
    default_lam: float = 0.0
    _sel_lam: Optional[float] = None

    # fit metadata (recorded by _record_fit; None until fitted)
    model_names: Optional[List[str]] = None
    embed_dim: Optional[int] = None
    fit_seed: Optional[int] = None

    def _record_fit(self, ds: RoutingDataset, seed: int) -> None:
        self.model_names = list(ds.model_names)
        self.embed_dim = int(ds.dim)
        self.fit_seed = int(seed)

    def fit(self, ds: RoutingDataset, seed: int = 0) -> "Router":
        raise NotImplementedError

    def predict_utility(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """X: (Q, D) raw embeddings -> (s_hat (Q, M), c_hat (Q, M))."""
        raise NotImplementedError

    # ---- artifact contract ----
    def state_dict(self):
        """Flat {key: np.ndarray} of every fitted tensor (see artifacts.py)."""
        from .artifacts import collect_state
        return collect_state(self)

    def load_state_dict(self, state) -> "Router":
        from .artifacts import restore_state
        return restore_state(self, state)
