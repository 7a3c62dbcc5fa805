"""RoutingPipeline of the port (mirrors `repro.serving.pipeline`): one
object for the router lifecycle fit -> evaluate -> save -> load -> serve.

    pipe = RoutingPipeline("knn100-ivfpq@lam=0.5").fit(ds)
    pipe.evaluate()["auc"]                       # paper's Pareto AUC protocol
    path = pipe.save("artifacts/knn100-ivfpq")   # npz + manifest
    svc = RoutingPipeline.load(path).serve(engines)
    svc.serve_texts(["prove the lemma"], lam=0.2)

Every family of the registry fits and evaluates on ``device`` (the card by
default; ``device="cpu"`` runs the plain versions).  The artifact is the
reference's format, so a pipeline of either package loads the other's.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

from repro_torch.core import eval as E
from repro_torch.core.dataset import RoutingDataset
from repro_torch.core.routers import (Router, RouterSpec, load_router,
                                      make_router, save_router, spec_of)
from .router_service import RouterService


class RoutingPipeline:
    def __init__(self, router: Union[Router, RouterSpec, str], *,
                 seed: int = 0, device: str = "cuda"):
        if isinstance(router, (str, RouterSpec)):
            router = make_router(router, device=device)
        self.router = router
        self.seed = seed
        self.dataset: Optional[RoutingDataset] = None

    @property
    def spec(self) -> str:
        return spec_of(self.router)

    @property
    def fitted(self) -> bool:
        return self.router.model_names is not None

    def fit(self, ds: RoutingDataset) -> "RoutingPipeline":
        self.router.fit(ds, seed=self.seed)
        self.dataset = ds
        return self

    def fit_selection(self, ds: RoutingDataset, lam: float) -> "RoutingPipeline":
        self.router.fit_selection(ds, lam, seed=self.seed)
        self.dataset = ds
        return self

    def evaluate(self, ds: Optional[RoutingDataset] = None,
                 split: str = "test") -> Dict:
        """Paper §4.3 utility-prediction protocol: Pareto-hull AUC."""
        ds = ds or self.dataset
        if ds is None:
            raise ValueError("evaluate() needs a dataset: fit first or pass "
                             "ds= explicitly")
        return E.utility_auc(self.router, ds, split=split)

    def save(self, path):
        """Persist the fitted router (npz + json manifest); returns path."""
        return save_router(self.router, path)

    @classmethod
    def load(cls, path, *, seed: int = 0,
             device: str = "cuda") -> "RoutingPipeline":
        """Rebuild a pipeline from a `save` artifact — no training data."""
        return cls(load_router(path, device=device), seed=seed)

    def serve(self, engines: Dict, *, lam: Optional[float] = None,
              **service_kw) -> RouterService:
        """Wrap the fitted router in a RouterService over ``engines``."""
        if not self.fitted:
            raise ValueError("serve() needs a fitted router: call fit(ds) or "
                             "load(path) first")
        return RouterService(self.router, engines, lam=lam, **service_kw)
