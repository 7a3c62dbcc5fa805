"""The collectives of the sharded paths, over a group whose backend the
caller chose when starting it: `all_gather` (the retrieval's top-k merge,
the batch-sharded route's outputs, the expert-parallel layer's output
and aux, the sequence-sharded decode's partials) and `all_to_all` (the
expert-parallel dispatch).

NCCL takes CUDA tensors, gloo host tensors and (as the port's chip runs
found on an H100 with torch 2.11, `chip_smoke.py` phase 12b) CUDA
tensors too, for both collectives: a CUDA buffer goes to the group as it
is, with no copy of the port's.  A backend that refuses one raises; no
backend is chosen or switched here.

All three have a gradient, for the expert-parallel layer in training:

- `all_to_all`: the transposed all-to-all, which with equal splits is the
  same exchange run on the output's gradient;
- `all_gather`, `all_reduce_mean` and `all_reduce_sum`: their result is
  REPLICATED, the same value that every rank then uses identically in one
  global loss.  The
  gradient of that loss with respect to a rank's block is then that
  rank's own slice of the incoming gradient (times 1 / n for the mean),
  which every rank already holds (for the sum, the incoming gradient
  itself).  An all-gather whose backward is a reduce-scatter (sum), as
  ``all_gather_tensor_autograd``'s is, would multiply every gradient by
  the group's size here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _gather_into(out, x, group):
    fn = getattr(dist, "all_gather_single", None)
    if fn is None:      # torch before all_gather_single
        fn = dist.all_gather_into_tensor
    fn(out, x, group=group)


def _gather(x, group):
    n = dist.get_world_size(group)
    src = x.contiguous()
    flat = src.reshape((1,) + tuple(src.shape)) if src.ndim == 0 else src
    out = src.new_empty((n * flat.shape[0],) + tuple(flat.shape[1:]))
    _gather_into(out, flat, group)
    return out.reshape((n,) + tuple(src.shape))


def _exchange(x, group):
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[dist.get_rank(ctx.group)], None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in group-rank order.  Gradient: a
    replicated result's (module docstring), this rank's slice."""
    return _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (n, ...) split along dim 0: row j goes to group rank j, and row
    j of the result came from group rank j.  Gradient: the same exchange
    of the output's gradient."""
    return _AllToAll.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the group's ranks (by `all_gather`, so the
    sum runs in group-rank order, the same on every rank).  Gradient: a
    replicated result's, 1 / n of the incoming gradient."""
    return all_gather(x, group).mean(0)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks.  Gradient: a replicated
    result's (module docstring), the incoming gradient itself."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group's ranks (no gradient)."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
