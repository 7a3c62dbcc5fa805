"""The collectives of the sharded paths, over a group whose backend the
caller chose when starting it: `all_gather` (the retrieval's top-k merge,
the batch-sharded route's outputs, the expert-parallel layer's output
and aux) and `all_to_all` (the expert-parallel dispatch).

NCCL takes CUDA tensors, gloo host tensors and (as the port's chip runs
found on an H100 with torch 2.11, `chip_smoke.py` phase 12b) CUDA
tensors too, for both collectives: a CUDA buffer goes to the group as it
is, with no copy of the port's.  A backend that refuses one raises; no
backend is chosen or switched here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _gather_into(out, x, group):
    fn = getattr(dist, "all_gather_single", None)
    if fn is None:      # torch before all_gather_single
        fn = dist.all_gather_into_tensor
    fn(out, x, group=group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in group-rank order."""
    n = dist.get_world_size(group)
    src = x.contiguous()
    flat = src.reshape((1,) + tuple(src.shape)) if src.ndim == 0 else src
    out = src.new_empty((n * flat.shape[0],) + tuple(flat.shape[1:]))
    _gather_into(out, flat, group)
    return out.reshape((n,) + tuple(src.shape))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (n, ...) split along dim 0: row j goes to group rank j, and row
    j of the result came from group rank j."""
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the group's ranks (by `all_gather`, so the
    sum runs in group-rank order, the same on every rank)."""
    return all_gather(x, group).mean(0)
