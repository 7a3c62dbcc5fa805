"""AdamW with f32 master weights, global-norm clipping and a warmup+cosine
schedule (mirrors `repro.training.optimizer`): the reference's formulas on
torch tensors, not `torch.optim.AdamW`.

Parameters and gradients are ``{name: tensor}`` dictionaries (e.g.
``dict(lm.named_parameters())``).  Where the reference returns new trees,
`update` writes the new parameters and optimizer state in place, which
saves a copy of every f32 buffer per step."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


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
    """m, v (zeros) and the f32 master copy of every parameter; step 0."""
    f32 = torch.float32
    return {"m": {n: torch.zeros_like(p, dtype=f32) for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=f32) for n, p in params.items()},
            "master": {n: p.detach().to(f32).clone()
                       for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tensors: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors.values()))


@torch.no_grad()
def update(opt: OptConfig, grads: Tensors, state: dict,
           params: Tensors) -> Dict[str, torch.Tensor]:
    """One AdamW step: clip by the global norm, bias-corrected moments,
    decoupled weight decay on the f32 master, parameters cast back to
    their dtype.  ``state`` and ``params`` are updated in place.  Returns
    {"grad_norm", "lr"}."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(opt.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(opt, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - opt.b1 ** stepf
    bc2 = 1 - opt.b2 ** stepf
    dev = next(iter(params.values())).device
    scale, lr, bc1, bc2 = (t.to(dev) for t in (scale, lr, bc1, bc2))
    for name, p in params.items():
        g = grads[name].float() * scale
        m = opt.b1 * state["m"][name] + (1 - opt.b1) * g
        v = opt.b2 * state["v"][name] + (1 - opt.b2) * g * g
        mh = m / bc1
        vh = v / bc2
        master = state["master"][name]
        new_master = master - lr * (mh / (torch.sqrt(vh) + opt.eps)
                                    + opt.weight_decay * master)
        state["m"][name].copy_(m)
        state["v"][name].copy_(v)
        master.copy_(new_master)
        p.copy_(new_master)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
