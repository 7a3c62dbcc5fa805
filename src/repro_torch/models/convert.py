"""JAX parameter pytree -> the port's modules.

``params_from_jax(tree, cfg)`` takes the tree `repro.models.model.
init_params` returns, with numpy arrays as leaves
(``jax.tree.map(np.asarray, params)``), and unstacks the scanned group
axis into one `Block` per layer, so the same weights compute the same
function in both packages.  Covers the dense engine LMs and the query
encoder (which uses ``embed`` and the stack)."""
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
            arr = np.array(state[name], np.float32)
            if arr.shape != tuple(t.shape):
                raise ValueError(f"{name}: jax shape {arr.shape} != port "
                                 f"shape {tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr))
    return lm
