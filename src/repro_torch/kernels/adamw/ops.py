"""Wrapper of AdamW's two multi-tensor passes (`kernel.cu`), which take the
place of `training.optimizer`'s per-tensor norm and `_foreach` chain for
the leaves on the card.

`clip_scale(grads, clip_norm)` gives the global L2 norm of the gradients
and the clip's scale min(clip_norm / (norm + 1e-9), 1) as f32 0-d tensors
on their device, `sumsq(grads)` the sum of their squares as an f64 0-d
tensor (a sharded model's local shards, which the caller all-reduces);
`adamw_update` runs one AdamW step over the leaves in place.  Neither waits for the card nor copies anything to it: a launch
carries up to `MAX_LEAVES` leaves' pointers, sizes and flags in its
parameter block (`plan` cuts the leaves into launches), the step's scalars
stay on the device, and every launch goes to the current stream (a side
stream while `_GraphedStep` warms up, the capture's while it captures).
CPU tensors take the plain versions (`ref.py`); CUDA tensors launch the
kernels or raise: bf16 or f32 gradients and parameters, an f32 state,
contiguous, on one device.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import torch

from .. import _build
from .ref import adamw_reference, clip_scale_reference, sumsq_reference

MAX_LEAVES = 64     # kernel.cu: MAX_LEAVES, leaves a launch
CHUNK = 16384       # kernel.cu: CHUNK, elements a block
G_BF16, P_BF16, VECTOR = 1, 2, 4    # kernel.cu: a leaf's flags
DTYPES = (torch.float32, torch.bfloat16)
#: the clip's guard: clip_norm / (norm + 1e-9), as `training.optimizer`
TINY = 1e-9


class Launch(NamedTuple):
    """One launch of a pass: the indices of its leaves in the caller's
    list, and each leaf's first block with the launch's block count
    last."""
    leaves: tuple
    start: tuple


def plan(numels: Sequence[int], max_leaves: int = MAX_LEAVES,
         chunk: int = CHUNK) -> List[Launch]:
    """The launches of a pass over leaves of ``numels`` elements, in order:
    up to ``max_leaves`` leaves each, ceil(n / chunk) blocks a leaf; an
    empty leaf takes no block and no place."""
    out, cur, start = [], [], [0]
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(cur) == max_leaves:
            out.append(Launch(tuple(cur), tuple(start)))
            cur, start = [], [0]
        cur.append(i)
        start.append(start[-1] + -(-n // chunk))
    if cur:
        out.append(Launch(tuple(cur), tuple(start)))
    return out


def grad_ok(g, dev) -> bool:
    """Whether the norm pass takes gradient ``g`` on ``dev``: a plain
    tensor (a DTensor's norm needs its shards' sums all-reduced), bf16 or
    f32, contiguous."""
    return (not hasattr(g, "to_local") and g.device == dev
            and g.dtype in DTYPES and g.is_contiguous())


def leaf_ok(dev, g, m, v, w, p) -> bool:
    """Whether the update pass takes one leaf on ``dev``: its gradient, m,
    v, the f32 master ``w`` and the parameter ``p`` (local shards of a
    DTensor), contiguous and of one size, g and p bf16 or f32."""
    n = g.numel()
    return (grad_ok(g, dev) and p.dtype in DTYPES and p.device == dev
            and p.is_contiguous() and p.numel() == n
            and all(t.dtype == torch.float32 and t.device == dev
                    and t.is_contiguous() and t.numel() == n
                    for t in (m, v, w)))


def leaf_flags(g, p=None, *state) -> int:
    """A leaf's flags (`kernel.cu`): G_BF16 for a bf16 gradient, P_BF16
    for a bf16 parameter ``p``, VECTOR where the gradient, the parameter
    and the ``state`` tensors all start on a boundary of 4 of their
    elements (a vector load)."""
    ts = (g,) + (() if p is None else (p,)) + state
    bf16 = torch.bfloat16
    return ((G_BF16 if g.dtype == bf16 else 0)
            | (P_BF16 if p is not None and p.dtype == bf16 else 0)
            | (VECTOR if all(t.data_ptr() % (4 * t.element_size()) == 0
                             for t in ts) else 0))


def _lib():
    lib = _build.load("adamw")
    if lib.adamw_update_launch.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        table = [ptrs, ctypes.POINTER(ctypes.c_longlong),
                 ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_ubyte)]
        for fn in (lib.adamw_sumsq_launch, lib.adamw_norm_finish,
                   lib.adamw_update_launch):
            fn.restype = ctypes.c_int
        lib.adamw_sumsq_launch.argtypes = (
            [ctypes.c_int, ptrs] + table[1:] + [ctypes.c_void_p] * 2)
        lib.adamw_norm_finish.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_float] * 2
            + [ctypes.c_void_p] * 4)
        lib.adamw_update_launch.argtypes = (
            [ctypes.c_int] + [ptrs] * 5 + table[1:] + [ctypes.c_void_p] * 4
            + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    return lib


def _table(launch, numels, flags):
    k = len(launch.leaves)
    return ((ctypes.c_longlong * k)(*(numels[i] for i in launch.leaves)),
            (ctypes.c_int * (k + 1))(*launch.start),
            (ctypes.c_ubyte * k)(*(flags[i] for i in launch.leaves)))


def _pointers(ts, launch):
    return (ctypes.c_void_p * len(launch.leaves))(
        *(ts[i].data_ptr() for i in launch.leaves))


def _finish(grads, clip_norm, what):
    """The norm pass over ``grads`` (bf16 or f32 contiguous CUDA tensors):
    its partial sums' launches, then the finishing one, which writes the
    0-d tensors it returns: the f32 (norm, scale) for ``what`` "clip", the
    f64 sum of squares for "sumsq"."""
    dev = grads[0].device
    if dev.type != "cuda" or not all(grad_ok(g, dev) for g in grads):
        raise ValueError("adamw norm pass: bf16 or f32 contiguous CUDA "
                         "gradients on one device expected")
    numels = [g.numel() for g in grads]
    flags = [leaf_flags(g) for g in grads]
    launches = plan(numels)
    total = sum(ln.start[-1] for ln in launches)
    partial = torch.empty((max(total, 1),), dtype=torch.float32, device=dev)
    if what == "clip":
        out = tuple(torch.empty((), dtype=torch.float32, device=dev)
                    for _ in range(2))
        ptrs = (out[0].data_ptr(), out[1].data_ptr(), None)
    else:
        out = torch.empty((), dtype=torch.float64, device=dev)
        ptrs = (None, None, out.data_ptr())
    lib, stream = _lib(), _build.stream_ptr(dev)
    base = partial.data_ptr()
    for ln in launches:
        _build.check(lib.adamw_sumsq_launch(
            len(ln.leaves), _pointers(grads, ln), *_table(ln, numels, flags),
            base, stream), "adamw_sumsq")
        base += 4 * ln.start[-1]
    _build.check(lib.adamw_norm_finish(
        partial.data_ptr(), total, float(clip_norm), TINY, *ptrs, stream),
        "adamw_norm_finish")
    clip_scale.launches += len(launches) + 1
    return out


def clip_scale(grads: Sequence[torch.Tensor], clip_norm: float):
    """(norm, scale) of the gradients ``grads``: their global L2 norm, as
    f32, and min(clip_norm / (norm + 1e-9), 1) (a NaN norm gives a NaN
    scale), each an f32 0-d tensor on their device.  Partial sums of g^2
    a block of `CHUNK` elements, added in a fixed order: repeats give the
    same bits."""
    if not grads:
        raise ValueError("clip_scale: no gradients")
    if grads[0].device.type == "cpu":
        return clip_scale_reference(grads, clip_norm, TINY)
    return _finish(grads, clip_norm, "clip")


def sumsq(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the squares of every element of ``grads``, an f64 0-d
    tensor on their device, by `clip_scale`'s pass and in its order (its
    launches counted there)."""
    if not grads:
        raise ValueError("sumsq: no gradients")
    if grads[0].device.type == "cpu":
        return sumsq_reference(grads)
    return _finish(grads, 0.0, "sumsq")


def adamw_update(grads, m, v, master, params, scale, lr, bc1, bc2,
                 consts) -> None:
    """One AdamW step over the leaves in place (lists of one length):
    g = g scale, the moments m and v, the f32 master less lr times the
    bias-corrected update plus weight decay, and the parameter the master
    in its own dtype.  ``scale``, ``lr``, ``bc1`` and ``bc2`` are f32 0-d
    tensors on the leaves' device; ``consts`` (b1, 1 - b1, b2, 1 - b2,
    eps, weight decay) Python floats, each rounded once to f32 as the
    `_foreach` ops round them."""
    leaves = list(zip(grads, m, v, master, params))
    if not leaves:
        return
    dev = grads[0].device
    if dev.type == "cpu":
        return adamw_reference(grads, m, v, master, params, scale, lr, bc1,
                               bc2, consts)
    if dev.type != "cuda" or not all(leaf_ok(dev, *lf) for lf in leaves):
        raise ValueError("adamw_update: bf16 or f32 gradients and "
                         "parameters, an f32 state, contiguous, one size a "
                         "leaf, on one CUDA device expected")
    scalars = (scale, lr, bc1, bc2)
    if any(s.dtype != torch.float32 or s.device != dev or s.numel() != 1
           for s in scalars):
        raise ValueError("adamw_update: scale, lr, bc1 and bc2 must be f32 "
                         "scalars on the leaves' device")
    numels = [g.numel() for g in grads]
    flags = [leaf_flags(g, p, mi, vi, wi) for g, mi, vi, wi, p in leaves]
    lib, stream = _lib(), _build.stream_ptr(dev)
    consts = [float(c) for c in consts]
    launches = plan(numels)
    for ln in launches:
        _build.check(lib.adamw_update_launch(
            len(ln.leaves), *(_pointers(ts, ln)
                              for ts in (grads, m, v, master, params)),
            *_table(ln, numels, flags), *(s.data_ptr() for s in scalars),
            *consts, stream), "adamw_update")
    adamw_update.launches += len(launches)


#: CUDA launches of the norm pass (`clip_scale` and `sumsq`): its partial
#: sums' (one a `plan` launch) and the finishing one
clip_scale.launches = 0
#: CUDA launches of the update pass (one a `plan` launch)
adamw_update.launches = 0
