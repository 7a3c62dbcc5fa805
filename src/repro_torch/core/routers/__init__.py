"""Router registry of the port: the exact kNN router, spec-addressable."""
from .base import Router
from .knn import KNNRouter
from .spec import RouterSpec, format_spec, make_router, parse_spec, spec_of

__all__ = ["Router", "KNNRouter", "RouterSpec", "make_router", "parse_spec",
           "format_spec", "spec_of"]
