"""Router registry of the port (mirrors `repro.core.routers`): every method
of Tables 2 and 5 — the kNN router (exact, IVF and IVF-PQ retrieval) and
the learned baselines (linear, matrix factorization, MLP, graph, attentive,
double attentive) — plus LinUCB, spec-addressable and persisted through
the reference's artifact format.  Each module registers its family with
``@spec.register``; the registry, the paper's ordering and
``make_router`` derive from those registrations."""
from .base import Router
from .knn import KNNRouter
from .linear import LinearRouter
from .mf import LinearMFRouter, MLPMFRouter
from .mlp import MLPRouter
from .graph import GraphRouter
from .attentive import AttentiveRouter, DoubleAttentiveRouter
from .bandit import LinUCBRouter
from .spec import (RouterSpec, build_registry, format_spec, make_router,
                   paper_order, parse_spec, router_config, spec_of)
from .artifacts import ArtifactCorruptError, load_router, save_router

#: canonical spec name -> factory, one entry per registered variant
REGISTRY = build_registry()

#: the paper's Table 2/5 router ordering (derived from registration ranks)
PAPER_ORDER = paper_order()

__all__ = ["Router", "KNNRouter", "LinearRouter", "LinearMFRouter",
           "MLPMFRouter", "MLPRouter", "GraphRouter", "AttentiveRouter",
           "DoubleAttentiveRouter", "LinUCBRouter", "REGISTRY",
           "PAPER_ORDER", "RouterSpec", "make_router", "parse_spec",
           "format_spec", "spec_of", "router_config", "save_router",
           "load_router", "ArtifactCorruptError"]
