"""Spec-addressable router construction (mirrors
`repro.core.routers.spec`)::

    <family><k?>[-ivf|-ivfpq][@key=val,...]

    knn10               kNN router, k=10, exact retrieval
    knn100-ivf          same, inverted-file approximate retrieval
    knn100-ivfpq        same, product-quantized IVF (ADC + exact re-rank)
    knn100-ivfpq@m=16,nbits=8,rerank=4   ... with explicit PQ knobs
    knn100@lam=0.5      ... with a default routing lambda of 0.5
    knn10@weights=softmax,temperature=10.0
    knn100-ivf@online=1,delta_cap=4096   streaming index: appended rows land
                        in a delta tier the next route retrieves, with a
                        re-cluster once it exceeds delta_cap

``lam`` is reserved: it sets the router's default cost/quality trade-off
used when a request carries no lambda of its own; families whose
constructor also takes ``lam`` (LinUCB) receive it in both places.  The
registry (``build_registry``) and the paper's table order
(``paper_order``) derive from the registrations.  Constructor overrides
passed to ``make_router`` (``make_router("knn10", device="cpu")``) apply on
top of the spec's kwargs.  ``parse_spec`` / ``format_spec`` round-trip;
legacy underscore names (``knn10_ivf``) are accepted as aliases of the
dashed form.
"""
from __future__ import annotations

import dataclasses
import inspect
import re
from functools import partial
from typing import Dict, Mapping, Optional, Tuple

RESERVED_KEYS = ("lam",)

_SPEC_RE = re.compile(
    r"^(?P<family>[a-z][a-z0-9_]*?)(?P<k>\d+)?(?P<ivf>-ivf(?P<pq>pq)?)?$")


@dataclasses.dataclass(frozen=True)
class RouterSpec:
    """Parsed form of a spec string.  ``pq`` refines ``ivf``: the ``-ivfpq``
    suffix parses to ``ivf=True, pq=True``."""
    family: str
    k: Optional[int] = None
    ivf: bool = False
    kwargs: Mapping[str, object] = dataclasses.field(default_factory=dict)
    pq: bool = False


@dataclasses.dataclass(frozen=True)
class RouterFamily:
    family: str
    cls: type
    k_param: Optional[str]          # constructor kwarg that receives <k>
    default_ks: Tuple[int, ...]     # registry-enumerated k variants
    supports_ivf: bool
    paper_rank: Optional[int]       # position in the paper's tables; None = extra
    ctor_params: frozenset

    def variant_names(self):
        for k in self.default_ks or (None,):
            yield format_spec(RouterSpec(self.family, k=k))
            if self.supports_ivf:
                yield format_spec(RouterSpec(self.family, k=k, ivf=True))
                yield format_spec(RouterSpec(self.family, k=k, ivf=True,
                                             pq=True))


FAMILIES: Dict[str, RouterFamily] = {}


def register(family: str, *, k_param: Optional[str] = None,
             default_ks: Tuple[int, ...] = (), supports_ivf: bool = False,
             paper_rank: Optional[int] = None):
    """Class decorator: declare ``cls`` as the implementation of ``family``."""
    def deco(cls):
        params = inspect.signature(cls.__init__).parameters
        ctor = frozenset(p for p in params if p != "self")
        if family in FAMILIES:
            raise ValueError(f"router family {family!r} registered twice")
        FAMILIES[family] = RouterFamily(family, cls, k_param,
                                        tuple(default_ks), supports_ivf,
                                        paper_rank, ctor)
        cls.spec_family = family
        return cls
    return deco


def _parse_value(raw: str):
    """Typed kwarg values: int -> float -> bool -> str."""
    if re.fullmatch(r"[+-]?\d+", raw):
        return int(raw)
    try:
        return float(raw)
    except ValueError:
        pass
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    return raw


def _format_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def parse_spec(spec: str) -> RouterSpec:
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(f"empty router spec: {spec!r}")
    base, sep, kwstr = spec.strip().partition("@")
    if base.endswith("_ivfpq"):                    # legacy alias knn10_ivfpq
        base = base[:-6] + "-ivfpq"
    elif base.endswith("_ivf"):                    # legacy alias knn10_ivf
        base = base[:-4] + "-ivf"
    m = _SPEC_RE.fullmatch(base)
    if not m:
        raise ValueError(f"unparseable router spec {spec!r} "
                         f"(grammar: <family><k?>[-ivf|-ivfpq][@key=val,...])")
    family = m.group("family")
    fam = FAMILIES.get(family)
    if fam is None:
        raise ValueError(f"unknown router family {family!r} in spec {spec!r}; "
                         f"registered: {', '.join(sorted(FAMILIES))}")
    k = int(m.group("k")) if m.group("k") else None
    if k is not None and fam.k_param is None:
        raise ValueError(f"family {family!r} takes no <k> suffix "
                         f"(spec {spec!r})")
    ivf = m.group("ivf") is not None
    pq = m.group("pq") is not None
    if ivf and not fam.supports_ivf:
        raise ValueError(f"family {family!r} has no IVF backend (spec {spec!r})")
    kwargs = {}
    if sep:
        if not kwstr:
            raise ValueError(f"dangling '@' in router spec {spec!r}")
        for item in kwstr.split(","):
            key, eq, raw = item.partition("=")
            if not eq or not key or not raw:
                raise ValueError(f"malformed kwarg {item!r} in spec {spec!r} "
                                 f"(expected key=val)")
            if key not in fam.ctor_params and key not in RESERVED_KEYS:
                raise ValueError(
                    f"unknown kwarg {key!r} for family {family!r} "
                    f"(spec {spec!r}); constructor takes: "
                    f"{', '.join(sorted(fam.ctor_params))}")
            kwargs[key] = _parse_value(raw)
    return RouterSpec(family, k=k, ivf=ivf, kwargs=kwargs, pq=pq)


def format_spec(spec: RouterSpec) -> str:
    """Canonical spec string (round-trips through ``parse_spec``)."""
    s = spec.family + ("" if spec.k is None else str(spec.k))
    if spec.ivf:
        s += "-ivfpq" if spec.pq else "-ivf"
    if spec.kwargs:
        s += "@" + ",".join(f"{k}={_format_value(v)}"
                            for k, v in sorted(spec.kwargs.items()))
    return s


def make_router(spec, **overrides):
    """Construct a router from a spec string or a RouterSpec."""
    if isinstance(spec, str):
        spec = parse_spec(spec)
    fam = FAMILIES.get(spec.family)
    if fam is None:
        raise ValueError(f"unknown router family {spec.family!r}")
    kw = {} if spec.k is None else {fam.k_param: spec.k}
    if spec.ivf:
        kw["index"] = "ivfpq" if spec.pq else "ivf"
    kw.update(spec.kwargs)
    kw.update(overrides)
    lam = kw.get("lam")
    if "lam" not in fam.ctor_params:
        kw.pop("lam", None)
    unknown = sorted(set(kw) - fam.ctor_params)
    if unknown:
        raise ValueError(f"unknown constructor kwargs {unknown} for family "
                         f"{spec.family!r}; takes: "
                         f"{', '.join(sorted(fam.ctor_params))}")
    router = fam.cls(**kw)
    if lam is not None:
        router.default_lam = float(lam)
    return router


def spec_of(router) -> str:
    """Canonical spec string of a router instance (family + k + index;
    non-default constructor kwargs live in the artifact manifest config)."""
    fam = FAMILIES[router.spec_family]
    k = getattr(router, fam.k_param) if fam.k_param else None
    index = getattr(router, "index", None)
    return format_spec(RouterSpec(fam.family, k=k,
                                  ivf=index in ("ivf", "ivfpq"),
                                  pq=index == "ivfpq"))


def router_config(router) -> Dict[str, object]:
    """Constructor kwargs reconstructing this instance (JSON-serializable).
    The ``device`` and the ``mesh`` are handles of this process, not
    configuration: they are left out (the reference leaves out its
    ``mesh`` too), so a manifest written here loads in the reference."""
    cfg = {}
    for p in sorted(FAMILIES[router.spec_family].ctor_params):
        if p in ("device", "mesh") or not hasattr(router, p):
            continue
        cfg[p] = getattr(router, p)
    return cfg


def build_registry() -> Dict[str, object]:
    """name -> factory, enumerated from the registered families; a factory
    takes constructor overrides (``REGISTRY["mlp"](device="cpu")``)."""
    return {name: partial(make_router, name)
            for fam in FAMILIES.values() for name in fam.variant_names()}


def paper_order():
    """The paper's Table 2/5 router ordering, derived from registration."""
    return [format_spec(RouterSpec(fam.family, k=k))
            for fam in sorted((f for f in FAMILIES.values()
                               if f.paper_rank is not None),
                              key=lambda f: f.paper_rank)
            for k in fam.default_ks or (None,)]
