"""Router API of the port (mirrors `repro.core.routers.base`).  Every
router supports the paper's two formulations:

  * utility prediction — ``predict_utility(X) -> (s_hat, c_hat)``; routing
    selects ``argmax_m s_hat - lam * c_hat`` over any lambda grid (this is
    what traces the full Pareto front, §4.3);
  * model selection — ``fit_selection(ds, lam)`` + ``select(X)``; trained
    against gold labels derived at a fixed lambda.

Every fit records ``model_names`` / ``embed_dim`` / ``fit_seed`` so a
serving layer can validate arity without probing, and ``state_dict()`` /
``load_state_dict()`` round-trip every fitted tensor named in the class's
``state_attrs`` (see `artifacts.py` for the on-disk format, shared with the
reference).  Routers take numpy in and give numpy out, as the reference's
do; each family computes on its ``device``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..dataset import RoutingDataset


def normalize_rows(X: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(X, axis=1, keepdims=True)
    return (X / np.maximum(n, 1e-12)).astype(np.float32)


def gold_labels(scores: np.ndarray, costs: np.ndarray, lam: float) -> np.ndarray:
    """argmax_m s - lam*c per query (selection-formulation training signal)."""
    return np.argmax(scores - lam * costs, axis=1)


class Router:
    name = "base"
    is_parametric = True
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

    @property
    def n_models(self) -> Optional[int]:
        """Output arity, known once fitted (or loaded from an artifact)."""
        return None if self.model_names is None else len(self.model_names)

    def _dev_of(self, attr: str) -> torch.Tensor:
        """Device copy of the host array ``self.<attr>``, uploaded once and
        kept while the attribute holds the same array (a fit or a load that
        assigns a new one uploads it anew)."""
        cache = self.__dict__.setdefault("_dev_copies", {})
        arr = getattr(self, attr)
        ent = cache.get(attr)
        if ent is None or ent[0] is not arr:
            ent = (arr, torch.from_numpy(np.ascontiguousarray(arr)).to(
                self.device))
            cache[attr] = ent
        return ent[1]

    # ---- utility formulation ----
    def fit(self, ds: RoutingDataset, seed: int = 0) -> "Router":
        raise NotImplementedError

    def predict_utility(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """X: (Q, D) raw embeddings -> (s_hat (Q, M), c_hat (Q, M))."""
        raise NotImplementedError

    # ---- selection formulation ----
    def fit_selection(self, ds: RoutingDataset, lam: float,
                      seed: int = 0) -> "Router":
        """Default: reuse the utility fit; selection = utility argmax."""
        self._sel_lam = lam
        return self.fit(ds, seed=seed)

    def select(self, X: np.ndarray) -> np.ndarray:
        if self._sel_lam is None:
            raise RuntimeError(
                f"{type(self).__name__}.select() called before "
                f"fit_selection(); fit the selection formulation first or "
                f"route via predict_utility() at an explicit lambda")
        s, c = self.predict_utility(X)
        return np.argmax(s - self._sel_lam * c, axis=1)

    # ---- artifact contract ----
    def state_dict(self):
        """Flat {key: np.ndarray} of every fitted tensor (see artifacts.py)."""
        from .artifacts import collect_state
        return collect_state(self)

    def load_state_dict(self, state) -> "Router":
        from .artifacts import restore_state
        return restore_state(self, state)
