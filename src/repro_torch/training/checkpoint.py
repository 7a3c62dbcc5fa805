"""Flat-npz checkpoints of parameter / optimizer trees (mirrors
`repro.training.checkpoint`), written atomically through the port's
`persist.py`.

A tree is a nested dict of tensors, e.g. ``dict(lm.named_parameters())``
or an optimizer state; leaves are saved under
their path joined with "/".  numpy has no bfloat16, so every
floating-point leaf is stored as f32 (exact for bf16) and `restore` casts
back to the template leaf's dtype.  The layout is the port's own: the
reference stores scanned layer groups stacked, the port one leaf per
layer."""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import persist


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def save(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    persist.atomic_savez(path, **{k: _to_numpy(v)
                                  for k, v in _flatten(tree).items()})


def restore(path: str, template):
    """A tree shaped like ``template`` with the checkpoint's values, each
    leaf on the template leaf's device and in its dtype.  A missing leaf
    raises KeyError, a leaf of another shape ValueError."""
    data = np.load(path)

    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in t.items()}
        key = prefix[:-1]
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key]
        if arr.shape != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(t.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=t.device,
                                                  dtype=t.dtype)
    return walk(template, "")
