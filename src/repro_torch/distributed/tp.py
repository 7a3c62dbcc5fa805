"""Tensor parallelism over the mesh's "model" axis, for the model code
(`launch.shardings.shard_lm` lays the parameters out).

Under `shard_lm` every parameter reaches the model code, after FSDP's
all-gather over the data axes, as a ``DTensor`` on the one-dimensional
"model" sub-mesh: ``Shard(d)`` where its rule puts "model" on dim d,
``Replicate()`` elsewhere.  The activations are DTensors on that sub-mesh
too (a data rank's own batch, replicated over "model"), so the matrix
products shard by DTensor's own rules (a column-parallel product gives a
``Shard(-1)`` output, a row-parallel one a ``Partial`` that
`distributed.sharding.constrain` brings back).  The helpers below do what
DTensor has no rule for, explicitly:

- `split_heads`: (B, S, n hd) -> (B, S, n, hd), all-gathered first when
  the shards do not fall on head boundaries (n not a multiple of the
  axis), and `merge_heads` back, its gradient replicated then;
- `attend`: a kernel call on each rank's own heads through ``local_map``
  (the kernel wrappers read ``data_ptr()``, so no DTensor reaches them);
- `embed`: the vocabulary-sharded lookup, each rank its own rows, summed;
- `decode_merge`: the sequence-sharded decode's partial outputs merged by
  their log-sum-exp (flash-decoding over the "model" ranks);
- `unsharded`: FSDP's all-gather of a module for the decode step, which
  calls no module's forward.

On plain tensors (the unsharded model) every helper is the plain code.
Every sharded call runs under ``implicit_replication`` (a plain tensor
beside a DTensor, positions or masks, is replicated), which the step
builders (`launch.steps`) enter.  That replication happens below
autograd, so a plain tensor that needs a gradient must never meet a
DTensor (its gradient would come back a DTensor): values every rank
holds whole and differentiates, the loss and the MoE aux, stay plain
end to end.
"""
from __future__ import annotations

import contextlib
import functools


@functools.lru_cache(maxsize=None)
def _classes():
    """(DTensor, FSDPModule), imported once, on first use: the unsharded
    model's hot paths ask per layer and call."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor
    return DTensor, FSDPModule


def is_dt(t) -> bool:
    return isinstance(t, _classes()[0])


def mesh_of(t):
    """The DTensor's mesh, None for a plain tensor."""
    return t.device_mesh if is_dt(t) else None


def full(t):
    """A plain tensor of the whole value (all-gathered or reduced)."""
    return t.full_tensor() if is_dt(t) else t


def local(t):
    return t.to_local() if is_dt(t) else t


def replicate(t):
    from torch.distributed.tensor import Replicate
    if not is_dt(t):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def replicated_like(t, mesh):
    """A plain tensor every rank holds whole, as a ``Replicate`` DTensor on
    ``mesh`` (itself where ``mesh`` is None)."""
    if mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()], run_check=False)


def rank_size(mesh):
    """(this rank's coordinate, ranks) on a one-dimensional mesh."""
    return mesh.get_local_rank(), mesh.size()


def _grad_contiguous(t):
    """``t``, whose gradient is made contiguous on its way back: a kernel's
    plain version hands back strided gradients, and DTensor's backward of
    the reshape before it views the local gradient."""
    import torch

    class _G(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g.contiguous()
    return _G.apply(t) if t.requires_grad else t


def data_gathered(w, partial_over_model=False):
    """A parameter `launch.shardings.shard_lm` shards over the whole mesh
    by hand (an f32 leaf of a bf16 model), whole as a plain tensor, its
    gradient averaged over the data ranks (their batches differ, as
    FSDP's reduce-scatter averages them) and summed over "model" where
    each model rank used it on its own tokens."""
    if not is_dt(w) or w.device_mesh.ndim == 1:
        return None
    from torch.distributed.tensor import Partial, Replicate
    mesh = w.device_mesh
    whole = w.redistribute(mesh, [Replicate()] * mesh.ndim)
    over_model = Partial() if partial_over_model else Replicate()
    grads = [over_model if name == "model" else Partial("avg")
             for name in mesh.mesh_dim_names]
    return whole.to_local(grad_placements=grads)


def grad_whole(t):
    """``t`` (a block's row-parallel output), whose gradient is made whole
    (``Replicate``) on its way back: with the sequence sharded over
    "model" (``--seq-parallel``) the residual's gradient is
    sequence-sharded, and the product's backward would flatten (batch,
    seq) over a sharded sequence; Megatron's sequence parallelism
    all-gathers it here.  A no-op on a plain tensor and where the
    gradient is whole already."""
    if is_dt(t) and t.requires_grad:
        t.register_hook(replicate)
    return t


def split_heads(t, n: int, hd: int):
    """(B, S, n hd) -> (B, S, n, hd); a DTensor sharded off the heads'
    boundaries is all-gathered first (DTensor cannot unflatten it)."""
    if is_dt(t) and n % t.device_mesh.size() and any(
            p.is_shard() for p in t.placements):
        t = replicate(t)
    return t.reshape(*t.shape[:-1], n, hd)


def merge_heads(t):
    """(..., n, hd) -> (..., n hd).  Where n does not divide over the axis
    the gradient coming back is replicated first (its product's backward
    may shard n hd across the heads, which DTensor cannot unflatten)."""
    y = t.reshape(*t.shape[:-2], -1)
    if is_dt(y) and y.requires_grad and t.shape[-2] % y.device_mesh.size():
        y.register_hook(replicate)
    return y


def attend(kernel, q, k, v, **kw):
    """``kernel(q, k, v, **kw)`` (flash attention: q (B, Sq, H, hd), k / v
    (B, Sk, KV, hd)) on each rank's own query heads.  Key / value heads
    are sharded with them where KV divides by the axis; where one KV head
    serves every query head of a rank, they are replicated and each rank
    takes its own (its gradient a ``Partial`` sum); otherwise (H not a
    multiple of the axis, or a rank's heads across KV heads) every rank
    runs all heads."""
    if not is_dt(q):
        return kernel(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    r, m = rank_size(mesh)
    H, KV = q.shape[2], k.shape[2]
    R, S2 = [Replicate()], [Shard(2)]

    def call(kk_lo=None):
        def fn(ql, kl, vl):
            ql, kl, vl = (_grad_contiguous(t) for t in (ql, kl, vl))
            if kk_lo is not None:
                kl, vl = kl[:, :, kk_lo:kk_lo + 1], vl[:, :, kk_lo:kk_lo + 1]
            return kernel(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                          **kw)
        return fn

    if H % m == 0 and KV % m == 0:
        return local_map(call(), out_placements=S2,
                         in_placements=(S2, S2, S2), device_mesh=mesh)(
            *(t.redistribute(mesh, S2) for t in (q, k, v)))
    hl, G = H // m, H // KV
    if H % m == 0 and G % hl == 0:
        return local_map(call(r * hl // G), out_placements=S2,
                         in_placements=(S2, R, R),
                         in_grad_placements=(S2, [Partial()], [Partial()]),
                         device_mesh=mesh)(
            q.redistribute(mesh, S2), replicate(k), replicate(v))
    return local_map(call(), out_placements=R, in_placements=(R, R, R),
                     device_mesh=mesh)(*(replicate(t) for t in (q, k, v)))


def on_heads(fn, n_heads, args, in_dims, out_dims):
    """``fn(*args)`` on each rank's own heads through ``local_map``: arg i
    sharded on ``in_dims[i]`` (None: replicated; a None or plain arg
    passes as it is), output j on ``out_dims[j]``; every rank runs all
    heads where ``n_heads`` is not a multiple of the axis."""
    if not any(is_dt(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if is_dt(a))
    split = n_heads % mesh.size() == 0

    def pl(d):
        return [Shard(d)] if split and d is not None else [Replicate()]
    ins = tuple(pl(d) if is_dt(a) else None for a, d in zip(args, in_dims))
    args = tuple(a.redistribute(mesh, p) if p is not None else a
                 for a, p in zip(args, ins))

    # a replicated input of a heads-sharded call: each rank's gradient is
    # its heads' share, summed over the ranks
    grads = tuple(None if p is None else [Partial()] if split and d is None
                  else p for p, d in zip(ins, in_dims))

    def local_fn(*a):
        return fn(*(x if x is None else _grad_contiguous(x) for x in a))
    return local_map(local_fn, out_placements=tuple(pl(d) for d in out_dims),
                     in_placements=ins, in_grad_placements=grads,
                     device_mesh=mesh)(*args)


def embed(w, tokens):
    """``w[tokens]``: a vocabulary-sharded table looks up its own rows (0
    for a token outside them) and the ranks' rows are summed, a
    ``Partial`` brought back to ``Replicate``."""
    if not is_dt(w):
        return w[tokens]
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    if not w.placements[0].is_shard():
        return local_map(lambda wl, t: F.embedding(t, wl),
                         out_placements=[Replicate()],
                         in_placements=([Replicate()], None),
                         device_mesh=mesh)(w, tokens)
    r, _ = rank_size(mesh)

    def lookup(wl, t):
        lo = t - r * wl.shape[0]
        ok = (lo >= 0) & (lo < wl.shape[0])
        return F.embedding(lo.clamp(0, wl.shape[0] - 1), wl) \
            * ok[..., None].to(wl.dtype)
    x = local_map(lookup, out_placements=[Partial()],
                  in_placements=(w.placements, None), device_mesh=mesh)(
        w, tokens)
    return replicate(x)


def seq_rows(pos, S_local, mesh):
    """A sequence-sharded cache of ``S_local`` rows a rank: the last valid
    row of each slot in this rank's rows, -1 where none, for a slot whose
    valid rows are the prefix [0, min(pos, S - 1)] of the whole cache (both
    cache modes, `kernels.decode_attention`)."""
    r, m = rank_size(mesh)
    last = pos.clamp(max=S_local * m - 1) - r * S_local
    return last.clamp(-1, S_local - 1).to(pos.dtype)


def write_row(cache, rows, slot, value, mesh):
    """``cache[rows, slot] = value`` for a global ``slot`` (B,) into a
    sequence-sharded cache: only the rank that holds the row writes it."""
    import torch
    S_l = cache.shape[1]
    lo = slot - mesh.get_local_rank() * S_l
    ok = (lo >= 0) & (lo < S_l)
    lc = lo.clamp(0, S_l - 1)
    keep = ok.view(-1, *([1] * (value.ndim - 1)))
    cache[rows, lc] = torch.where(keep, value.to(cache.dtype),
                                  cache[rows, lc])


def decode_merge(out, lse, mesh):
    """The ranks' partial attention outputs (B, H, d) over their cache
    rows, with their log-sum-exp (B, H), merged into the whole cache's
    output (every rank the same; 0 where no rank had a valid row)."""
    import torch
    from repro_torch.distributed import comm
    group = mesh.get_group()
    outs = comm.all_gather(out.float(), group)          # (m, B, H, d)
    lses = comm.all_gather(lse.float(), group)          # (m, B, H)
    mx = lses.amax(0)
    live = torch.isfinite(mx)
    w = torch.exp(lses - torch.where(live, mx, torch.zeros_like(mx)))
    w = torch.where(torch.isfinite(lses), w, torch.zeros_like(w))
    den = w.sum(0)
    num = (w[..., None] * outs).sum(0)
    return torch.where(live[..., None], num / torch.where(
        live, den, torch.ones_like(den))[..., None],
        torch.zeros_like(num)).to(out.dtype)


@contextlib.contextmanager
def unsharded(module):
    """FSDP's all-gather of ``module``'s own parameters for the block of
    code inside (a no-op for a module FSDP does not manage)."""
    if not isinstance(module, _classes()[1]):
        yield
        return
    module.unshard()
    try:
        yield
    finally:
        module.reshard()
