"""AdamW with f32 master weights, global-norm clipping and a warmup+cosine
schedule (mirrors `repro.training.optimizer`): the reference's formulas on
torch tensors, not `torch.optim.AdamW`.

Parameters and gradients are ``{name: tensor}`` dictionaries (e.g.
``dict(lm.named_parameters())``).  Where the reference returns new trees,
`update` writes the new parameters and optimizer state in place, which
saves a copy of every f32 buffer per step.

On the card `update` runs AdamW and its clip as two hand-written passes
over every leaf (`kernels.adamw`), which take bf16 or f32 contiguous
leaves and refuse any other; on the CPU it runs multi-tensor
(``_foreach``) ops, the same bits.

On a sharded model (`launch.shardings.shard_lm`) the parameters, their
gradients and the state are DTensors of matching placements: `update`
runs the same elementwise update on their local shards.  On the CPU
`global_norm` sums each tensor's whole square (its ``Partial`` sum
all-reduced); on the card the norm pass sums the local shards' squares,
one all-reduced scalar for the leaves of each placement
(`sharded_sumsq`)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch import tracing
from repro_torch.kernels.adamw import ops as adamw_ops

Tensors = Dict[str, torch.Tensor]

#: f32 bytes of the leaves one round of `update`'s multi-tensor ops takes on
#: the CPU: its temporaries (about 18 bytes a parameter) are one group's,
#: not the whole model's.  A leaf larger than this is a group of its own.
GROUP_BYTES = 1 << 30


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_ratio: float = 0.1


def schedule(opt: OptConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (int or tensor), computed in f32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(opt.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(opt.total_steps - opt.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return opt.lr * warm * (opt.min_lr_ratio + (1 - opt.min_lr_ratio) * cos)


def init(params: Tensors) -> dict:
    """m, v (zeros) and the f32 master copy of every parameter; step 0, on
    the parameters' device, so a step's schedule never waits for a copy
    from the host."""
    f32 = torch.float32
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros_like(p, dtype=f32) for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=f32) for n, p in params.items()},
            "master": {n: p.detach().to(f32).clone()
                       for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def global_norm(tensors: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(_whole(torch.sum(torch.square(t.float())))
                          for t in tensors.values()))


def clip_factor(clip_norm: float, gnorm: torch.Tensor) -> torch.Tensor:
    """The clip's factor min(clip_norm / (gnorm + 1e-9), 1)."""
    return torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)


def sharded_sumsq(grads) -> torch.Tensor:
    """The sum of the squares of every element of the gradients ``grads``
    (DTensors, or plain tensors taken as replicated), an f64 0-d tensor:
    the norm pass (`adamw_ops.sumsq`) over the local shards of the leaves
    of each mesh and placements, and its scalar all-reduced over the mesh
    dims that shard them (a replicated leaf's squares counted once).  A
    ``Partial`` gradient (a sum not yet reduced) is refused."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    sets = {}
    for g in grads:
        key = None
        if hasattr(g, "to_local"):
            if any(pl.is_partial() for pl in g.placements):
                raise ValueError("sharded_sumsq: a Partial gradient; "
                                 "redistribute it first")
            key = (g.device_mesh, tuple(pl.is_shard() for pl in g.placements))
        sets.setdefault(key, []).append(_local(g))
    total = None
    for key, local in sets.items():
        s = adamw_ops.sumsq(local)
        if key is not None and any(key[1]):
            s = DTensor.from_local(s, key[0], [Partial() if sh else Replicate()
                                               for sh in key[1]],
                                   run_check=False).full_tensor()
        total = s if total is None else total + s
    return total


def groups(names, tensors: Tensors, limit: int = GROUP_BYTES):
    """``names`` in order, cut into runs whose f32 bytes stay within
    ``limit`` (a larger leaf alone)."""
    out, cur, nbytes = [], [], 0
    for n in names:
        b = 4 * _local(tensors[n]).numel()
        if cur and nbytes + b > limit:
            out.append(cur)
            cur, nbytes = [], 0
        cur.append(n)
        nbytes += b
    if cur:
        out.append(cur)
    return out


@torch.no_grad()
def update(opt: OptConfig, grads: Tensors, state: dict,
           params: Tensors, group_bytes: int = GROUP_BYTES
           ) -> Dict[str, torch.Tensor]:
    """One AdamW step: clip by the global norm, bias-corrected moments,
    decoupled weight decay on the f32 master, parameters cast back to
    their dtype.  ``state`` and ``params`` are updated in place, the step
    counter too, so a step captured in a CUDA graph replays as the next
    step.  On the card every leaf goes through the kernels' norm and
    update passes (`adamw_ops`), which raise on a leaf they cannot take;
    on the CPU through multi-tensor (``_foreach``) ops, one launch for
    many parameters, in the order of the reference's per-leaf formula,
    over `groups` of leaves of at most ``group_bytes`` f32 bytes in turn.
    Every element takes the same operations whatever the path or the
    grouping, so the numbers are the same bits.  Counts
    "optimizer.leaves" and "optimizer.fused_leaves" (`tracing`).  Returns
    {"grad_norm", "lr"}."""
    state["step"].add_(1)
    step = state["step"]
    names = list(params)
    dev = next(iter(params.values())).device
    on_card = dev.type == "cuda"
    with tracing.span("train.clip"):
        gl = list(grads.values())
        if not on_card:
            gnorm = global_norm(grads)
            scale = clip_factor(opt.clip_norm, gnorm)
        elif any(hasattr(g, "to_local") for g in gl):
            gnorm = torch.sqrt(sharded_sumsq(gl).float())
            scale = clip_factor(opt.clip_norm, gnorm)
        else:
            gnorm, scale = adamw_ops.clip_scale(gl, opt.clip_norm)
    lr = schedule(opt, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - opt.b1 ** stepf
    bc2 = 1 - opt.b2 ** stepf
    scale, lr, bc1, bc2 = (t.to(dev) for t in (scale, lr, bc1, bc2))
    if on_card:
        adamw_ops.adamw_update(
            *([_local(ts[n]) for n in names] for ts in (
                grads, state["m"], state["v"], state["master"], params)),
            scale, lr, bc1, bc2, (opt.b1, 1 - opt.b1, opt.b2, 1 - opt.b2,
                                  opt.eps, opt.weight_decay))
    else:
        for group in groups(names, params, group_bytes):
            _adamw(opt, group, grads, state, params, scale, lr, bc1, bc2)
    tracing.count("optimizer.leaves", len(names))
    tracing.count("optimizer.fused_leaves", len(names) if on_card else 0)
    return {"grad_norm": gnorm, "lr": lr}


def _adamw(opt, names, grads, state, params, scale, lr, bc1, bc2):
    """The moments' and weights' multi-tensor ops over the leaves
    ``names``."""
    m, v, master = ([_local(state[k][n]) for n in names]
                    for k in ("m", "v", "master"))
    g = torch._foreach_mul([_local(grads[n]).float() for n in names], scale)
    # m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
    torch._foreach_mul_(m, opt.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - opt.b1))
    torch._foreach_mul_(v, opt.b2)
    torch._foreach_add_(v, torch._foreach_mul(
        torch._foreach_mul(g, 1 - opt.b2), g))
    # master -= lr (m / bc1 / (sqrt(v / bc2) + eps) + wd master)
    den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(den, opt.eps)
    upd = torch._foreach_div(torch._foreach_div(m, bc1), den)
    torch._foreach_add_(upd, torch._foreach_mul(master, opt.weight_decay))
    torch._foreach_sub_(master, torch._foreach_mul(upd, lr))
    torch._foreach_copy_([_local(params[n]) for n in names], master)
