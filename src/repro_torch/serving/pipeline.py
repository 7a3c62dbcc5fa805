"""RoutingPipeline of the port (mirrors `repro.serving.pipeline`): one
object for the router lifecycle fit -> save -> load -> serve.

    pipe = RoutingPipeline("knn100-ivfpq@lam=0.5").fit(ds)
    path = pipe.save("artifacts/knn100-ivfpq")   # npz + manifest
    svc = RoutingPipeline.load(path).serve(engines)
    svc.serve_texts(["prove the lemma"], lam=0.2)

The artifact is the reference's format, so a pipeline of either package
loads the other's.  The reference's ``fit_selection`` and ``evaluate`` wait
for the port of the selection formulation and of `repro.core.eval`.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

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
