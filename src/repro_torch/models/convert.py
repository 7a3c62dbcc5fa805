"""JAX parameter pytree <-> the port's modules.

``params_from_jax(tree, cfg, device)`` takes the tree `repro.models.model.
init_params` returns, with numpy arrays as leaves
(``jax.tree.map(np.asarray, params)``), and unstacks the scanned group
axis of ``stack/groups`` and ``stack/tail`` into one module per layer (the
shared block of ``stack/shared`` becomes ``LM.shared``), and that of
``encoder/groups`` (stacked over ``encoder_layers``) into ``LM.encoder``,
so the same weights compute the same function in both packages.  Covers
every architecture (the decoder layers' ``cross`` / ``norm_cross``,
``frontend_proj`` and ``enc_norm`` included) and the query encoder (which
uses ``embed`` and the stack).
Every leaf keeps its dtype: a JAX leaf whose dtype differs from the port's
parameter (an f32 ``A_log`` or MoE ``router`` in a bf16 model stays f32 on
both sides) is refused.  ``params_to_jax(lm, cfg)`` is the inverse: the
reference's stacked tree, which `training.checkpoint.save_lm` writes.
Both converters default to the card, like every entry point of the port.

``router_params_from_jax(flat, device)`` does the same for a learned
router: the reference's parameter tree, as numpy arrays keyed by artifact
path below the attribute (``mlp_s/0/w``, ``self_attn/wq/b``), becomes the
port's tree of f32 tensors on ``device``, leaf for leaf (a weight keeps
the reference's ``(din, dout)`` layout).  `artifacts.load_router` reads
every router's ``_params`` / ``_sel_params`` through it, so a router
fitted in JAX predicts in the port."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .model import LM, enc_cfg
from .transformer import layer_specs


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = (tree if isinstance(tree, torch.Tensor)
                            else np.asarray(tree))


def _layer_sources(cfg):
    """(stack part, pattern slot, group) of each layer in execution order:
    the scanned groups, then the tail groups."""
    out = []
    for part, pattern, n in (("groups", cfg.pattern, cfg.n_groups),
                             ("tail", cfg.tail_pattern, cfg.n_tail_groups)):
        out += [(part, i, g) for g in range(n) for i in range(len(pattern))]
    return out


def _stacks(cfg):
    """(tree key, module list of the `LM`, its config) of each layer stack:
    the decoder's ``stack`` and an encoder-decoder's ``encoder``."""
    out = [("stack", "blocks", cfg)]
    if cfg.is_encoder_decoder:
        out.append(("encoder", "encoder", enc_cfg(cfg)))
    return out


_TOP = ("embed", "final_norm", "lm_head", "frontend_proj", "enc_norm")


def params_from_jax(tree, cfg, device="cuda", cast=False) -> LM:
    """The reference's tree -> an `LM` on ``device``.  ``cast`` (the
    checkpoint reader's) casts each leaf (numpy or torch) to the port's
    parameter dtype instead of refusing another dtype."""
    state: Dict[str, np.ndarray] = {}
    _flatten({k: tree[k] for k in _TOP if k in tree}, "", state)
    for key, mods, c in _stacks(cfg):
        stack = tree[key]
        sources = _layer_sources(c)
        assert len(sources) == len(layer_specs(c))
        for li, (part, i, g) in enumerate(sources):
            layer: Dict[str, np.ndarray] = {}
            _flatten(stack[part][i], "", layer)
            for name, arr in layer.items():
                state[f"{mods}.{li}.{name}"] = arr[g]
    if "shared" in tree["stack"]:
        _flatten(tree["stack"]["shared"], "shared.", state)
    lm = LM(cfg, device)
    own = lm.state_dict()
    if set(own) != set(state):
        raise ValueError(f"parameter names differ: port-only "
                         f"{sorted(set(own) - set(state))}, jax-only "
                         f"{sorted(set(state) - set(own))}")
    with torch.no_grad():
        for name, t in own.items():
            leaf = state[name]
            if leaf.shape != tuple(t.shape):
                raise ValueError(f"{name}: jax shape {leaf.shape} != port "
                                 f"shape {tuple(t.shape)}")
            if not isinstance(leaf, torch.Tensor):
                if not cast and str(leaf.dtype) != str(t.dtype).replace(
                        "torch.", ""):
                    raise ValueError(f"{name}: jax dtype {leaf.dtype} != "
                                     f"port dtype {t.dtype}")
                a = np.asarray(leaf, np.float32)
                leaf = torch.from_numpy(a if a.flags.writeable else a.copy())
            # to the device first, then the cast there
            t.copy_(leaf.to(t.device))
    return lm


def params_to_jax(lm, cfg):
    """The inverse of `params_from_jax`: the port's parameters (an `LM`, or
    a ``{name: tensor}`` mapping with its names, e.g. its gradients) as the
    reference's tree: ``embed``, ``final_norm``, ``lm_head``, ``stack``
    with ``groups`` / ``tail`` (one dict per pattern slot, every leaf
    stacked along a leading group axis) and ``shared``, and for a front
    end ``frontend_proj`` and ``encoder`` (``groups``) / ``enc_norm``.
    Leaves are numpy arrays, floating ones in f32 (exact for bf16; numpy
    has no bf16), stacked and cast on the tensors' device before the copy
    to the host."""
    named = dict(lm.state_dict() if isinstance(lm, torch.nn.Module) else lm)

    def arr(t):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).cpu().numpy()

    def nest(items):
        out: dict = {}
        for name, a in items:
            *path, leaf = name.split(".")
            d = out
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = a
        return out

    tree = nest((k, arr(v)) for k, v in named.items()
                if not k.startswith(("blocks.", "shared.", "encoder.")))
    for key, mods, c in _stacks(cfg):
        per_slot: Dict[tuple, Dict[str, list]] = {}
        for li, (part, i, g) in enumerate(_layer_sources(c)):
            slot = per_slot.setdefault((part, i), {})
            prefix = f"{mods}.{li}."
            for k, v in named.items():
                if k.startswith(prefix):
                    slot.setdefault(k[len(prefix):], []).append(v.detach())
        stack: dict = {}
        for part, pattern in (("groups", c.pattern),
                              ("tail", c.tail_pattern)):
            if pattern:
                stack[part] = [nest((k, arr(torch.stack(v))) for k, v in
                                    per_slot.get((part, i), {}).items())
                               for i in range(len(pattern))]
        tree[key] = stack
    shared = [(k[len("shared."):], arr(v)) for k, v in named.items()
              if k.startswith("shared.")]
    if shared:
        tree["stack"]["shared"] = nest(shared)
    return tree


def router_params_from_jax(flat: Dict[str, np.ndarray], device="cuda"):
    """{artifact path: array} of one router attribute -> the port's tree of
    f32 tensors on ``device`` (lists where every key at a level is a
    decimal index, dicts elsewhere, as the reference's reader rebuilds)."""
    # imported here: the routers' artifacts import this module
    from repro_torch.core.routers.nn_utils import to_device, unflatten_tree
    for key, arr in flat.items():
        if np.asarray(arr).dtype.kind != "f":
            raise ValueError(f"{key}: a router parameter must be floating, "
                             f"got {np.asarray(arr).dtype}")
    return to_device(unflatten_tree(dict(flat)), device)


def moe_shard(src, cfg, shard: int, n_shards: int, device="cuda"):
    """Expert block ``shard`` of ``n_shards`` (E / n_shards experts, the
    block an expert-parallel rank with that "model" coordinate holds) cut
    out of a full MoE layer: the port's `MoE`, or the reference's ``moe``
    params (``router``, ``w_gate``, ``w_up``, ``w_down`` and ``shared``,
    numpy arrays).  The router and the shared experts are whole."""
    from .moe import MoE
    E = cfg.n_experts
    if E % n_shards:
        raise ValueError(f"moe_shard: {n_shards} shards do not divide "
                         f"{E} experts")
    el = E // n_shards
    flat: Dict[str, object] = {}
    _flatten(dict(src.state_dict()) if isinstance(src, torch.nn.Module)
             else src, "", flat)
    out = MoE(cfg, device, n_local=el)
    with torch.no_grad():
        for name, t in out.state_dict().items():
            leaf = flat[name]
            if name.split(".")[0] in ("w_gate", "w_up", "w_down"):
                leaf = leaf[shard * el:(shard + 1) * el]
            if not isinstance(leaf, torch.Tensor):
                leaf = torch.from_numpy(np.array(leaf, np.float32))
            if tuple(leaf.shape) != tuple(t.shape):
                raise ValueError(f"moe_shard: {name} has shape "
                                 f"{tuple(leaf.shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(leaf.to(t.device))
    return out
