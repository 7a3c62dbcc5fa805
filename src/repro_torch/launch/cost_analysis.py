"""Collective-traffic, FLOP and memory accounting of one step on one rank:
the counterpart of `repro.launch.hlo_analysis` (as `analysis/rules/
graph_capture.py` is of the reference's `jit_cache.py`).

The reference parses the partitioned HLO text of a compiled step.  Eager
PyTorch has no HLO: `measure` runs the step once (under a fake process
group and ``FakeTensorMode`` for a dry-run, so nothing is allocated or
sent) and records

  * every c10d collective the step issues, as (kind, result bytes, group
    size), by a ``TorchDispatchMode`` over the ``c10d`` ops
    (`CollectiveRecorder`; ``torch.distributed.tensor.debug.
    CommDebugMode`` counts the same ops but not their bytes);
  * the FLOPs, from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
    products, as XLA's cost analysis counts them);
  * the peak of live tensor bytes, from ``torch.distributed._tools.
    mem_tracker.MemTracker``.

`collective_bytes` applies the reference's ring model to the records,
per rank, g = the group's size:

    all-gather        result_bytes * (g-1)/g
    reduce-scatter    result_bytes * (g-1)
    all-reduce        2 * result_bytes * (g-1)/g
    all-to-all        result_bytes * (g-1)/g
    collective-permute result_bytes

The reference's ``extrapolate`` exists because XLA visits a loop body
once; eager visits every layer, so it has no counterpart here (the
model-side dry-run decides whether one is needed).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

#: c10d op -> (kind, index of the argument whose bytes are the result)
_OPS = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_base_": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 0),
    "send": ("collective-permute", 0),
}


class CollectiveRecord(NamedTuple):
    kind: str            # one of KINDS
    result_bytes: int    # bytes of the collective's result on this rank
    group_size: int


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    if isinstance(a, (list, tuple)):
        return sum(_nbytes(x) for x in a)
    return 0


def _group_size(args) -> int:
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
    return 0


class CollectiveRecorder(TorchDispatchMode):
    """Records a `CollectiveRecord` for every c10d collective dispatched
    inside the mode (fake or real tensors)."""

    def __init__(self):
        super().__init__()
        self.records: List[CollectiveRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            op = _OPS.get(func.__name__.split(".")[0])
            if op is not None:
                kind, i = op
                self.records.append(CollectiveRecord(
                    kind, _nbytes(args[i]), _group_size(args)))
        return func(*args, **(kwargs or {}))


def collective_bytes(records) -> Dict[str, float]:
    """Per-rank collective traffic (bytes) by kind, and ``total``: the
    reference's ring model (its group of fewer than 2 counted as 2)."""
    out: Dict[str, float] = {k: 0.0 for k in KINDS}
    for kind, size, g in records:
        if size == 0:
            continue
        g = max(g, 2)
        if kind == "all-gather":
            traffic = size * (g - 1) / g
        elif kind == "reduce-scatter":
            traffic = size * (g - 1)
        elif kind == "all-reduce":
            traffic = 2 * size * (g - 1) / g
        elif kind == "all-to-all":
            traffic = size * (g - 1) / g
        else:
            traffic = float(size)
        out[kind] += traffic
    out["total"] = sum(out.values())
    return out


class StepRecord(NamedTuple):
    flops: int
    collectives: List[CollectiveRecord]
    peak_bytes: int


def measure(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the three counters: (its
    result, `StepRecord`)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    mt = MemTracker()
    rec = CollectiveRecorder()
    with mt, FlopCounterMode(display=False) as fc, rec:
        out = fn(*args, **kwargs)
    peak = max((v["Total"] for v in
                mt.get_tracker_snapshot("peak").values()), default=0)
    return out, StepRecord(int(fc.get_total_flops()), rec.records,
                           int(peak))


def cost_summary(rec: StepRecord) -> Dict[str, float]:
    """The step's FLOPs (``FlopCounterMode``); the bytes a kernel must move
    are the caller's reckoning (`knn_dryrun`: each input read once, each
    output written once), as `chip_smoke.bound` reckons them."""
    return {"flops": float(rec.flops)}


def memory_summary(rec: StepRecord) -> Dict[str, float]:
    """The peak of live tensor bytes on this rank (``MemTracker``)."""
    return {"peak_bytes": float(rec.peak_bytes)}
