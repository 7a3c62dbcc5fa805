"""Flat-npz checkpoints of parameter / optimizer trees (mirrors
`repro.training.checkpoint`), written atomically through the port's
`persist.py`.

A tree is a nested dict (or list) of tensors or arrays, e.g.
``dict(lm.named_parameters())`` or an optimizer state; leaves are saved
under their path joined with "/" (a list index is a path element, as the
reference's ``idx``).  numpy has no bfloat16, so every floating-point leaf
is stored as f32 (exact for bf16) and `restore` casts back to the template
leaf's dtype.

A model's parameters go in the reference's layout: `save_lm` writes the
tree of `convert.params_to_jax` (``stack/groups/<slot>/...`` stacked along
the group axis, ``stack/tail``, ``stack/shared``; ``frontend_proj``,
``encoder/groups/0/...`` stacked over the encoder's layers and
``enc_norm`` for a front end), which
`repro.training.checkpoint.restore` loads against a `repro.models.model.
init_params` template; `load_lm` reads such a file, the port's or the
reference's, into an `LM`.  The reference writes bf16 leaves through
``np.asarray``, which `np.load` returns as raw 2-byte voids (``|V2``):
`load_lm` takes them as bf16 bits.  The optimizer state stays in the
port's own layout (`save` / `restore`)."""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import persist


def _flatten(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return np.asarray(t, np.float32) if t.dtype.kind == "f" else t
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


def save_lm(path: str, lm, cfg) -> None:
    """An `LM`'s parameters in the reference's layout, every floating leaf
    f32 (the reference's `restore` casts them to its template's dtype)."""
    from repro_torch.models.convert import params_to_jax
    save(path, params_to_jax(lm, cfg))


def _leaf(arr: np.ndarray) -> torch.Tensor:
    """A leaf as `np.load` returns it (a fresh array) -> a tensor sharing
    its memory."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # a bf16 leaf written by the reference: raw bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_lm(path: str, cfg, device="cuda"):
    """An `LM` on ``device`` from a checkpoint in the reference's layout
    (`save_lm`'s, or the reference's `checkpoint.save` of its params).
    Each leaf is cast to the port's parameter dtype; a missing or extra
    parameter, or a leaf of another shape, raises."""
    from repro_torch.models.convert import params_from_jax
    data = np.load(path)
    tree: dict = {}
    for key in data.files:
        *path_, last = key.split("/")
        node = tree
        for p in path_:
            node = node.setdefault(p, {})
        node[last] = _leaf(data[key])

    def lists(node):
        # {"0": ..., "1": ...} under stack/groups and stack/tail -> lists
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            n = max(int(k) for k in node) + 1
            return [node.get(str(i), {}) for i in range(n)]
        return node
    tree = lists(tree)
    stack = tree.setdefault("stack", {})
    # slots without weights (the hybrid's shared-attention slots) have no
    # leaves in the file
    for part, pattern in (("groups", cfg.pattern), ("tail", cfg.tail_pattern)):
        if not pattern:
            continue
        have = stack.get(part, [])
        stack[part] = have + [{}] * (len(pattern) - len(have))
    return params_from_jax(tree, cfg, device=device, cast=True)
