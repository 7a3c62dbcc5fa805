"""Router registry of the port: the kNN router (exact, IVF and IVF-PQ
retrieval), spec-addressable, persisted through the reference's artifact
format."""
from .base import Router
from .knn import KNNRouter
from .spec import (RouterSpec, format_spec, make_router, parse_spec,
                   router_config, spec_of)
from .artifacts import ArtifactCorruptError, load_router, save_router

__all__ = ["Router", "KNNRouter", "RouterSpec", "make_router", "parse_spec",
           "format_spec", "spec_of", "router_config", "save_router",
           "load_router", "ArtifactCorruptError"]
