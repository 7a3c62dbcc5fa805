"""JAX parameter pytree -> the port's modules.

``params_from_jax(tree, cfg)`` takes the tree `repro.models.model.
init_params` returns, with numpy arrays as leaves
(``jax.tree.map(np.asarray, params)``), and unstacks the scanned group
axis into one `Block` or `SSMBlock` per layer, so the same weights compute
the same function in both packages.  Covers the dense engine LMs, the
Mamba-2 LM (``ssm.in_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``D``,
``dt_bias``, ``norm.scale``, ``out_proj``) and the query encoder (which
uses ``embed`` and the stack).  Every leaf keeps its dtype: a JAX leaf
whose dtype differs from the port's parameter (an f32 ``A_log`` in a bf16
model stays f32 on both sides) is refused."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .model import LM
from .transformer import layer_specs


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_jax(tree, cfg, device="cpu") -> LM:
    state: Dict[str, np.ndarray] = {}
    _flatten({k: tree[k] for k in ("embed", "final_norm", "lm_head")}, "",
             state)
    groups = tree["stack"]["groups"]
    n_pat = len(cfg.pattern)
    for li in range(len(layer_specs(cfg))):
        g, i = divmod(li, n_pat)
        layer: Dict[str, np.ndarray] = {}
        _flatten(groups[i], "", layer)
        for name, arr in layer.items():
            state[f"blocks.{li}.{name}"] = arr[g]
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
            if str(leaf.dtype) != str(t.dtype).replace("torch.", ""):
                raise ValueError(f"{name}: jax dtype {leaf.dtype} != port "
                                 f"dtype {t.dtype}")
            t.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return lm
