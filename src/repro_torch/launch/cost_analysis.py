"""Collective-traffic, FLOP and memory accounting of one step on one rank:
the counterpart of `repro.launch.hlo_analysis` (as `analysis/rules/
graph_capture.py` is of the reference's `jit_cache.py`).

The reference parses the partitioned HLO text of a compiled step.  Eager
PyTorch has no HLO: `measure` runs the step once (under a fake process
group and ``FakeTensorMode`` for a dry-run, so nothing is allocated or
sent) and records

  * every collective the step issues, as (kind, result bytes, group size),
    by a ``TorchDispatchMode`` over the ``c10d`` ops (the process-group
    calls: FSDP's all-gathers and reduce-scatters, `distributed.comm`)
    and the ``_c10d_functional`` ones (DTensor's redistributions)
    (`CollectiveRecorder`; ``torch.distributed.tensor.debug.
    CommDebugMode`` counts the same ops but not their bytes);
  * the FLOPs this rank does (`LocalFlopCounter`: the formulas of
    ``torch.utils.flop_counter``, matrix products as XLA's cost analysis
    counts them, on a DTensor op divided over the mesh axes its output is
    sharded or partial on, since a mode sees a DTensor op at its global
    shape), plus what the kernel wrappers report on fake tensors
    (`kernels.fake`: ``FlopCounterMode`` sees no kernel);
  * the peak of live tensor bytes, from ``torch.distributed._tools.
    mem_tracker.MemTracker``, or for a model under FSDP2 its FSDP-aware
    ``fsdp2_mem_tracker.FSDPMemTracker``.

`collective_bytes` applies the reference's ring model to the records,
per rank, g = the group's size:

    all-gather        result_bytes * (g-1)/g
    reduce-scatter    result_bytes * (g-1)
    all-reduce        2 * result_bytes * (g-1)/g
    all-to-all        result_bytes * (g-1)/g
    collective-permute result_bytes

The reference's `extrapolate` exists because XLA visits a loop body
once.  Eager tracing visits every layer, so the model-side dry-run
(`launch.dryrun`) traces the full depth and also the reference's
extrapolation points, and records both: `extrapolate` is the same linear
fit ``a + b g + c t`` over the points, which the full-depth trace checks.
"""
from __future__ import annotations

import math
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

#: ``_c10d_functional`` op -> kind (the result is the op's output)
_FUNCOL = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
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


def _named_group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


class CollectiveRecorder(TorchDispatchMode):
    """Records a `CollectiveRecord` for every c10d or functional collective
    dispatched inside the mode (fake or real tensors)."""

    def __init__(self):
        super().__init__()
        self.records: List[CollectiveRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__.split(".")[0]
        if func.namespace == "c10d":
            op = _OPS.get(name)
            if op is not None:
                kind, i = op
                self.records.append(CollectiveRecord(
                    kind, _nbytes(args[i]), _group_size(args)))
        elif func.namespace == "_c10d_functional" and name in _FUNCOL:
            self.records.append(CollectiveRecord(
                _FUNCOL[name], _nbytes(out), _named_group_size(args)))
        return out


class LocalFlopCounter(TorchDispatchMode):
    """The FLOPs this rank does, by ``torch.utils.flop_counter``'s formulas.
    A DTensor op is seen at its global shape; its local share is that over
    the sizes of the mesh axes its output is ``Shard`` or ``Partial`` on
    (a ``Replicate`` axis computes the whole).  Also the eager bytes: each
    op that is not a view reads its tensor inputs once and writes its
    outputs once (this rank's shards; no fusion, so an upper bound of what
    a fused step moves)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            self.flops += n // _split(out)
        if not func.is_view and func.namespace == "aten":
            self.bytes += _local_bytes(args) + _local_bytes(kwargs) \
                + _local_bytes(out)
        return out


def _local_bytes(a) -> int:
    if isinstance(a, torch.Tensor):
        t = getattr(a, "_local_tensor", a)
        return t.numel() * t.element_size()
    if isinstance(a, (list, tuple)):
        return sum(_local_bytes(x) for x in a)
    if isinstance(a, dict):
        return sum(_local_bytes(x) for x in a.values())
    return 0


def _split(out) -> int:
    from torch.distributed.tensor import DTensor
    first = out[0] if isinstance(out, (tuple, list)) else out
    if not isinstance(first, DTensor):
        return 1
    return math.prod(size for size, p in zip(first.device_mesh.shape,
                                             first.placements)
                     if not p.is_replicate())


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
    #: eager bytes (`LocalFlopCounter`)
    bytes: int = 0
    #: FLOPs the kernel wrappers reported on fake tensors, by kernel
    kernel_flops: Dict[str, float] = {}


def measure(fn, *args, module=None, external=(), **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the three counters: (its
    result, `StepRecord`).  ``module``, a model under FSDP2, takes the
    FSDP-aware memory tracker; ``external`` (tensors, modules) are live
    before the call and count toward the peak (the optimizer state, the
    inputs)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.kernels import fake
    try:
        from torch.distributed.fsdp import FSDPModule
    except ImportError:         # torch without FSDP2
        FSDPModule = ()
    if isinstance(module, FSDPModule):
        from torch.distributed._tools.fsdp2_mem_tracker import (
            FSDPMemTracker)
        mt = FSDPMemTracker(module)
    else:
        mt = MemTracker()
    if external:
        mt.track_external(*external)
    rec = CollectiveRecorder()
    fc = LocalFlopCounter()
    kernels: list = []
    fake.SINKS.append(kernels)
    try:
        with mt, fc, rec:
            out = fn(*args, **kwargs)
    finally:
        fake.SINKS.remove(kernels)
    peak = max((v["Total"] for v in
                mt.get_tracker_snapshot("peak").values()), default=0)
    by_kernel: Dict[str, float] = {}
    for name, f in kernels:
        by_kernel[name] = by_kernel.get(name, 0.0) + f
    flops = fc.flops + sum(by_kernel.values())
    return out, StepRecord(int(flops), rec.records, int(peak),
                           int(fc.bytes), by_kernel)


def cost_summary(rec: StepRecord) -> Dict[str, float]:
    """The step's FLOPs (`LocalFlopCounter` and the kernels') and eager
    bytes; `knn_dryrun` reckons a kernel's bytes itself (each input read
    once, each output written once), as `chip_smoke.bound` does."""
    return {"flops": float(rec.flops), "bytes": float(rec.bytes)}


def memory_summary(rec: StepRecord) -> Dict[str, float]:
    """The peak of live tensor bytes on this rank (``MemTracker``)."""
    return {"peak_bytes": float(rec.peak_bytes)}


def collective_bytes_by_group(records) -> Dict[str, float]:
    """`collective_bytes`' total split by the group's size, keyed by the
    size as a string: the roofline gives each group its link
    (`launch.mesh.link_bw`)."""
    out: Dict[str, float] = {}
    for r in records:
        key = str(max(r.group_size, 1))
        out[key] = out.get(key, 0.0) + collective_bytes([r])["total"]
    return out


def extrapolate(costs: Dict[tuple, Dict[str, float]], n_groups: int,
                n_tail: int) -> Dict[str, float]:
    """The reference's fit: ``costs`` keyed by (g, t) with values
    {metric: number}; fits cost = a + b g + c t (three points where there
    is a tail, solved exactly, the last point's value times g where the
    system is singular; else the line through two) and evaluates it at
    (n_groups, n_tail), for every metric key any point has."""
    import numpy as np
    keys = sorted(costs)
    out = {}
    metrics = set()
    for v in costs.values():
        metrics |= set(v)
    for mkey in metrics:
        if n_tail and len(keys) >= 3:
            (g1, t1), (g2, t2), (g3, t3) = keys[:3]
            A = np.array([[1, g1, t1], [1, g2, t2], [1, g3, t3]], float)
            y = np.array([costs[k][mkey] for k in keys[:3]])
            try:
                abc = np.linalg.solve(A, y)
            except np.linalg.LinAlgError:
                abc = np.array([0.0, y[-1], 0.0])
            out[mkey] = float(abc[0] + abc[1] * n_groups + abc[2] * n_tail)
        else:
            (g1, _), (g2, _) = keys[0], keys[1]
            y1, y2 = costs[keys[0]][mkey], costs[keys[1]][mkey]
            b = (y2 - y1) / max(g2 - g1, 1)
            a = y1 - b * g1
            out[mkey] = float(a + b * n_groups)
    return out
