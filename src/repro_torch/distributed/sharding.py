"""Logical-axis sharding rules and a context, so model code can name the
axes of an activation without importing mesh machinery (mirrors
`repro.distributed.sharding`).

``spec_for(mesh, logical)`` gives the mesh axes of each tensor dimension
exactly as the reference's ``PartitionSpec`` holds them (None, one axis
name, or a tuple of names); ``placements_for`` turns that into DTensor
placements, one ``Shard(dim)`` or ``Replicate()`` for each mesh dimension.
``constrain(x, ("batch", "seq", "embed"))`` is a no-op outside a
`sharding_context` and on a plain tensor (an SPMD rank's own shard); on a
``DTensor`` inside one it redistributes to the rule table's layout.
`active_mesh()` hands the context's mesh to `models.moe`'s expert-parallel
path.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

_state = threading.local()

# logical axis -> mesh axes (None = replicated)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "expert": "model",
    "vocab": "model",
    "capacity": None,
    "state": None,
    "fsdp": ("pod", "data"),
    "layers": None,
}


def _axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _filter_axes(mesh, axes):
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    present = tuple(a for a in axes if a in _axis_names(mesh))
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def spec_for(mesh, logical: Sequence[Optional[str]], rules=None) -> tuple:
    """Mesh axes of each dimension of a tensor with the ``logical`` axes:
    None (replicated), an axis name, or a tuple of names (major first).
    Axes the mesh lacks are dropped, and a mesh axis shards at most one
    dimension: the first logical axis that asks for it wins."""
    rules = rules or DEFAULT_RULES
    parts = []
    used = set()
    for name in logical:
        ax = None if name is None else _filter_axes(mesh, rules.get(name))
        if ax is not None:
            axs = (ax,) if isinstance(ax, str) else tuple(ax)
            axs = tuple(a for a in axs if a not in used)
            used |= set(axs)
            ax = None if not axs else (axs if len(axs) > 1 else axs[0])
        parts.append(ax)
    return tuple(parts)


def placements_for(mesh, logical: Sequence[Optional[str]], rules=None):
    """DTensor placements of `spec_for`'s layout: for each mesh dimension,
    ``Shard(d)`` of the tensor dimension it shards, else ``Replicate()``.
    Two mesh axes on one dimension shard it in mesh order, as a tuple of
    axes does in the reference (major first)."""
    from torch.distributed.tensor import Replicate, Shard
    spec = spec_for(mesh, logical, rules)
    owner = {}
    for d, ax in enumerate(spec):
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in _axis_names(mesh))


@contextlib.contextmanager
def sharding_context(mesh, rules=None):
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _state.ctx = prev


def active_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def constrain(x, logical: Sequence[Optional[str]]):
    """``x`` laid out by the active rule table: a ``DTensor`` is
    redistributed; a plain tensor, or any tensor outside a context or of
    another rank than ``logical``, passes through."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or x.ndim != len(logical):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    return x.redistribute(mesh, placements_for(mesh, logical, rules))
