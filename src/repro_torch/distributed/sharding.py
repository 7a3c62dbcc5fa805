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
    return spec_placements(mesh, spec_for(mesh, logical, rules))


def spec_placements(mesh, spec):
    """DTensor placements of a spec (a tuple of None, axis names or tuples
    of them, one a dimension) over ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard
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
    redistributed over its own mesh (the context's, or the "model"
    sub-mesh a sharded model's activations live on, where the batch axes
    are FSDP's and each rank holds its own rows), a ``Partial`` summed; a
    dimension the axis does not divide stays whole, as the reference's
    ``_fit_spec`` leaves it.  The gradient flowing back through the
    point is brought to the same layout (a ``Partial`` sum of the
    consumers' gradients all-reduced once here, as Megatron's tensor
    parallelism does), so no product downstream in the backward
    all-gathers a weight to keep a ``Partial`` operand.  A plain tensor, or
    any tensor outside a context or of another rank than ``logical``,
    passes through."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or x.ndim != len(logical):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    mesh, rules = x.device_mesh, ctx[1]
    pl = [Replicate() if p.is_shard() and x.shape[p.dim] % size else p
          for p, size in zip(placements_for(mesh, logical, rules),
                             mesh.shape)]
    y = x.redistribute(mesh, pl)
    if y.requires_grad:
        y.register_hook(lambda g: g if tuple(g.placements) == tuple(pl)
                        else g.redistribute(mesh, pl))
    return y
