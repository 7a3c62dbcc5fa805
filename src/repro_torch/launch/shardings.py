"""Parameter, optimizer, batch and cache layouts of the sharded steps (the
counterpart of `repro.launch.shardings`), and `shard_lm`, which lays a
model out by them.

2-D weight sharding, the reference's rule table `_RULES` entry for entry:
tensor-parallel over "model" (heads, ffn hidden, experts, vocabulary) and
FSDP over ("pod", "data") on the complementary matrix dim.  The port's
`LM` keeps one module per layer (no scanned group axis), so a rule's spec
has no leading None here; the leaf names (``wq``, ``w_gate`` of rank 3,
``A_log``, ...) are the reference's, the last part of a parameter's dotted
``named_parameters()`` name.  Where an axis product does not divide a
dimension the sharding is dropped (`_fit_spec`), never made uneven.  Decode
caches are sequence-sharded over "model" (flash-decoding: the ranks'
partial attention merged by log-sum-exp, `distributed.tp.decode_merge`)
and batch-sharded over the data axes.

A spec is the reference's ``PartitionSpec`` as a tuple (None, an axis name
or a tuple of names a dimension); `param_placements` and the others turn
it into DTensor placements over a ``DeviceMesh`` (`distributed.sharding.
placements_for`'s rule: a tuple of axes shards its dimension in mesh
order).

`shard_lm(lm, mesh)` is PyTorch's 2-D composition of the same rules:
every parameter becomes a DTensor on the "model" sub-mesh (``Shard`` on
its rule's "model" dim, else ``Replicate``), then FSDP2 (``fully_shard``,
each layer and the root) shards it over the data axes (a flattened
("pod", "data") sub-mesh on the multi-pod mesh) on its rule's FSDP dim
(``shard_placement_fn``).  FSDP2 reduce-scatters one dtype a unit, so an
f32 leaf with an FSDP axis in a bf16 model (the MoE router) is instead a
DTensor over the whole mesh by its rule, gathered where it is used
(`distributed.tp.data_gathered`, its gradient averaged over the data
ranks there).  A parameter whose rule has no FSDP axis (or
whose FSDP dim the axes do not divide) is FSDP's ``ignored_params``: it
stays replicated over the data axes, as the reference's spec has it, and
`LMSharding.sync_grads` averages its gradient over them.  Each rank feeds
its own batch rows (`batch_placements`), so the model code sees DTensors on
the "model" sub-mesh only (`distributed.tp`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

FSDP = ("pod", "data")
TP = "model"

# (leaf name, rank) -> logical spec
_RULES = {
    ("embed", 2): (TP, FSDP),
    ("lm_head", 2): (FSDP, TP),
    ("frontend_proj", 2): (None, FSDP),
    ("wq", 2): (FSDP, TP), ("wk", 2): (FSDP, TP), ("wv", 2): (FSDP, TP),
    ("wo", 2): (TP, FSDP),
    ("bq", 1): (TP,), ("bk", 1): (TP,), ("bv", 1): (TP,),
    ("w_gate", 2): (FSDP, TP), ("w_up", 2): (FSDP, TP),
    ("w_down", 2): (TP, FSDP),
    ("w_gate", 3): (TP, FSDP, None), ("w_up", 3): (TP, FSDP, None),
    ("w_down", 3): (TP, None, FSDP),
    ("router", 2): (FSDP, None),
    ("w_dkv", 2): (FSDP, None), ("w_dq", 2): (FSDP, None),
    ("w_uk", 2): (None, TP), ("w_uv", 2): (None, TP), ("w_uq", 2): (None, TP),
    ("in_proj", 2): (FSDP, TP), ("out_proj", 2): (TP, FSDP),
    ("conv_w", 2): (None, TP), ("conv_b", 1): (TP,),
    ("A_log", 1): (TP,), ("D", 1): (TP,), ("dt_bias", 1): (TP,),
    ("scale", 1): (None,),
}


def _names(mesh) -> tuple:
    """Axis names of a ``DeviceMesh`` or of a stand-in with
    ``axis_names`` (the reference's ``Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _sizes(mesh) -> Dict[str, int]:
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(_names(mesh), tuple(shape)))


def _ax(mesh, axes):
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    present = tuple(a for a in axes if a in _names(mesh))
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(ax, str):
        return sizes[ax]
    return math.prod(sizes[a] for a in ax)


def _fit_spec(mesh, parts, shape) -> tuple:
    """Drop sharding on dims whose size the axis product does not divide
    (odd vocabularies): the reference's ``_fit_spec``."""
    return tuple(None if ax is not None and dim % _axis_size(mesh, ax)
                 else ax for ax, dim in zip(parts, shape))


def leaf_spec(mesh, name: str, shape) -> tuple:
    """The spec of the parameter ``name`` (a dotted ``named_parameters()``
    name) of ``shape``: its leaf's rule, fitted; replicated where no rule
    names it."""
    rule = _RULES.get((name.split(".")[-1], len(shape)))
    if rule is None:
        return (None,) * len(shape)
    return _fit_spec(mesh, [_ax(mesh, r) for r in rule], shape)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``: for each mesh axis,
    ``Shard(d)`` of the dimension it shards, else ``Replicate()``."""
    from repro_torch.distributed.sharding import spec_placements
    return spec_placements(mesh, spec)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * len(_names(mesh))


def param_placements(mesh, named_shapes) -> Dict[str, tuple]:
    """{parameter name: placements} for ``{name: shape}`` (e.g. from
    ``named_parameters()`` of an `LM` on the meta device)."""
    return {n: placements(mesh, leaf_spec(mesh, n, s))
            for n, s in named_shapes.items()}


def opt_placements(mesh, named_shapes) -> dict:
    """`training.optimizer.init`'s state: m, v and the f32 master as the
    parameters, the step replicated."""
    ps = param_placements(mesh, named_shapes)
    return {"m": ps, "v": ps, "master": ps, "step": replicated(mesh)}


def batch_axes(mesh):
    return _ax(mesh, FSDP)


def batch_spec(mesh, shape) -> tuple:
    """tokens / labels (B, S), patches / frames (B, T, F): the batch over
    the data axes, fitted."""
    return _fit_spec(mesh, [batch_axes(mesh)] + [None] * (len(shape) - 1),
                     shape)


def batch_placements(mesh, batch_shapes) -> Dict[str, tuple]:
    return {k: placements(mesh, batch_spec(mesh, s))
            for k, s in batch_shapes.items()}


def cache_spec(mesh, leaf: str, shape, batch: int) -> tuple:
    """The reference's `cache_shardings` rule for one per-layer cache leaf
    (no group axis here): K / V (B, S, KV, hd) and the MLA latents (B, S,
    r) over (batch, "model" on S); the SSD state (B, H, P, N) over (batch,
    "model" on H); the conv state (B, K-1, C) over (batch, -, "model" on
    C); the batch axes only where ``batch`` > 1."""
    b = batch_axes(mesh) if batch > 1 else None
    tp = _ax(mesh, TP)
    if leaf in ("k", "v", "ck", "cv", "c", "kr", "ssd"):
        parts = [b, tp] + [None] * (len(shape) - 2)
    elif leaf == "conv":
        parts = [b, None, tp]
    else:
        parts = [None] * len(shape)
    return _fit_spec(mesh, parts, shape)


def cache_placements(mesh, caches, batch: int) -> List[Dict[str, tuple]]:
    """Placements of `models.model.init_caches`'s list of per-layer dicts
    (tensors or shapes)."""
    return [{k: placements(mesh, cache_spec(mesh, k, tuple(t.shape if
                                                          hasattr(t, "shape")
                                                          else t), batch))
             for k, t in c.items()} for c in caches]


# ---------------------------------------------------------------------------
# the model laid out by the rules: FSDP2 over the data axes + DTensor TP
# ---------------------------------------------------------------------------

def data_mesh(mesh):
    """The sub-mesh over the data axes (the FSDP axes): one axis, or
    ("pod", "data") flattened into one."""
    axes = tuple(a for a in FSDP if a in _names(mesh))
    if len(axes) == 1:
        return mesh[axes[0]]
    return mesh[axes]._flatten("_".join(axes))


class LMSharding:
    """What `shard_lm` leaves on the model (``lm.sharding``), for the step
    that trains or runs it."""

    def __init__(self, mesh, replicated_params, rules=None):
        self.mesh = mesh
        self.rules = rules
        self.tp_mesh = mesh[TP]
        self.dp_mesh = data_mesh(mesh)
        self.replicated_params = replicated_params

    @contextlib.contextmanager
    def context(self):
        """The sharded model's code runs inside: the rule table, and a
        plain tensor beside a DTensor taken as replicated."""
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        from repro_torch.distributed.sharding import sharding_context
        with sharding_context(self.mesh, self.rules), implicit_replication():
            yield

    def sync_grads(self, lm):
        """Bring every gradient to its parameter's placements (a replicated
        parameter's gradient may come back ``Partial`` over "model"), and
        average those of the parameters FSDP leaves replicated over the
        data axes (FSDP averages its own)."""
        import torch.distributed as dist
        for p in lm.parameters():
            g = p.grad
            if g is not None and tuple(g.placements) != tuple(p.placements):
                p.grad = g.redistribute(p.device_mesh, p.placements)
        if self.dp_mesh.size() == 1:
            return
        for p in self.replicated_params:
            if p.grad is not None:
                g = p.grad.to_local()
                dist.all_reduce(g, group=self.dp_mesh.get_group())
                g.div_(self.dp_mesh.size())

    def metric(self, t, reduce="mean"):
        """A step metric as one replicated plain tensor: the whole value,
        averaged (or summed) over the data ranks' batches."""
        from repro_torch.distributed import comm, tp
        t = tp.full(t).detach()
        if self.dp_mesh.size() == 1:
            return t
        got = comm.all_gather(t, self.dp_mesh.get_group())
        return got.sum(0) if reduce == "sum" else got.mean(0)


def _dims_of(spec):
    """(the dim "model" shards, the dim the data axes shard) of a spec."""
    tp_dim = fsdp_dim = None
    for d, ax in enumerate(spec):
        axs = () if ax is None else (ax,) if isinstance(ax, str) else ax
        if TP in axs:
            tp_dim = d
        elif axs:
            fsdp_dim = d
    return tp_dim, fsdp_dim


def _part(mesh, ax):
    """(this rank's block index, blocks) along a spec entry's axes, the
    first axis major."""
    if ax is None:
        return 0, 1
    axs = (ax,) if isinstance(ax, str) else tuple(ax)
    coords = dict(zip(_names(mesh), mesh.get_coordinate()))
    sizes = _sizes(mesh)
    idx = 0
    for a in axs:
        idx = idx * sizes[a] + coords[a]
    return idx, math.prod(sizes[a] for a in axs)


def local_shape(mesh, spec, shape) -> tuple:
    """This rank's block's shape of a tensor of ``shape`` laid out by
    ``spec``."""
    return tuple(d // _part(mesh, ax)[1] for ax, d in zip(spec, shape))


def rank_block(mesh, spec, t):
    """This rank's block of a whole tensor ``t`` laid out by ``spec``."""
    for d, ax in enumerate(spec):
        i, n = _part(mesh, ax)
        if n > 1:
            t = t.narrow(d, i * (t.shape[d] // n), t.shape[d] // n)
    return t.contiguous()


def shard_lm(lm, mesh, rules=None):
    """Lay ``lm`` (an `LM`, the same seeded weights on every rank, or fake
    tensors) out over ``mesh`` by the rules (module docstring): in place,
    every parameter a trainable DTensor.  Returns ``lm``, with
    ``lm.sharding`` (`LMSharding`; ``rules``, the activations' rule table
    its steps run under)."""
    from torch import nn
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if TP not in _names(mesh):
        raise ValueError(f"shard_lm: the mesh needs a {TP!r} axis, has "
                         f"{_names(mesh)}")
    tp_mesh = mesh[TP]
    r, m = tp_mesh.get_local_rank(), tp_mesh.size()
    fsdp_dim, ignored, by_hand = {}, set(), set()
    model_dtype = lm.embed.dtype
    for name, p in list(lm.named_parameters()):
        spec = leaf_spec(mesh, name, tuple(p.shape))
        tdim, fdim = _dims_of(spec)
        if fdim is not None and p.dtype != model_dtype:
            # FSDP2 reduce-scatters one dtype a unit: an f32 leaf of a
            # bf16 model (the MoE router) is sharded over the whole mesh
            # by its rule here, and gathered where it is used
            # (`distributed.tp.data_gathered`)
            dt = DTensor.from_local(
                rank_block(mesh, spec, p.detach()), mesh,
                placements(mesh, spec), run_check=False)
            new = nn.Parameter(dt, requires_grad=True)
            by_hand.add(new)
        else:
            data = p.detach()
            if tdim is not None:
                data = data.chunk(m, tdim)[r].contiguous()
            dt = DTensor.from_local(data, tp_mesh, [
                Shard(tdim) if tdim is not None else Replicate()],
                run_check=False)
            new = nn.Parameter(dt, requires_grad=True)
            if fdim is None:
                ignored.add(new)
            else:
                fsdp_dim[id(new)] = fdim
        owner, _, leaf = name.rpartition(".")
        setattr(lm.get_submodule(owner) if owner else lm, leaf, new)
    ignored |= by_hand
    dp = data_mesh(mesh)

    def placement(p):
        return Shard(fsdp_dim[id(p)])
    kw = dict(mesh=dp, shard_placement_fn=placement, ignored_params=ignored)
    for stack in ("blocks", "encoder"):
        for blk in getattr(lm, stack, ()):
            if any(True for _ in blk.parameters()):
                fully_shard(blk, **kw)
    fully_shard(lm, **kw)
    lm.sharding = LMSharding(mesh, [p for p in lm.parameters()
                                    if p in ignored and p not in by_hand],
                             rules)
    return lm
