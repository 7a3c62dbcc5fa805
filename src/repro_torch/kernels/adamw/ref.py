"""Plain versions of `kernel.cu`'s two passes: AdamW's per-element formula
in the order and roundings of `training.optimizer`'s `_foreach` chain,
the clip's norm and scale, and the kernels' map from a launch's blocks to
the slices of its leaves."""
from __future__ import annotations

import bisect

import torch


def adamw_elementwise(g, m, v, w, scale, lr, bc1, bc2, consts, sqrt):
    """One AdamW step of every element: returns the new (m, v, w).  Each
    product, sum, quotient and root is rounded on its own, as the
    `_foreach` ops round them: f32 torch tensors with ``sqrt`` torch.sqrt,
    or f32 numpy arrays and numpy f32 scalars with ``sqrt`` numpy.sqrt.
    ``consts`` (b1, 1 - b1, b2, 1 - b2, eps, weight decay)."""
    b1, omb1, b2, omb2, eps, wd = consts
    g = g * scale
    m = m * b1 + g * omb1
    v = v * b2 + (g * omb2) * g
    den = sqrt(v / bc2) + eps
    upd = (m / bc1) / den + w * wd
    return m, v, w - upd * lr


def adamw_reference(grads, m, v, master, params, scale, lr, bc1, bc2,
                    consts):
    """`ops.adamw_update` leaf by leaf: m, v, the master and the
    parameters updated in place."""
    for g, mi, vi, wi, p in zip(grads, m, v, master, params):
        nm, nv, nw = adamw_elementwise(g.float(), mi, vi, wi, scale, lr, bc1,
                                       bc2, consts, torch.sqrt)
        mi.copy_(nm)
        vi.copy_(nv)
        wi.copy_(nw)
        p.copy_(nw)


def sumsq_reference(grads):
    """The squares of every gradient's elements summed in f64, an f64 0-d
    tensor."""
    return torch.as_tensor(sum(torch.sum(torch.square(g.double()))
                               for g in grads), dtype=torch.float64)


def clip_scale_reference(grads, clip_norm, tiny):
    """(norm, scale): the L2 norm of every gradient together, summed in
    f64, as an f32 0-d tensor, and min(clip_norm / (norm + tiny), 1)."""
    gnorm = torch.sqrt(sumsq_reference(grads)).float()
    return gnorm, torch.clamp(clip_norm / (gnorm + tiny), max=1.0)


def block_slices(launch, numels, chunk):
    """(leaf, offset, count) of each block of ``launch`` (`ops.Launch`) in
    block order, found as `kernel.cu` finds them: the last leaf of the
    launch whose first block is at most the block's."""
    k = len(launch.leaves)
    for b in range(launch.start[-1]):
        j = bisect.bisect_right(launch.start, b, hi=k) - 1
        i = launch.leaves[j]
        off = (b - launch.start[j]) * chunk
        yield i, off, min(chunk, numels[i] - off)
