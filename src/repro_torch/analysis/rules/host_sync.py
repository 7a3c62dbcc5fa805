"""R1 — no host synchronization on the port's fused serving path.

Roots: any function named ``route_fused`` / ``serve_fused`` or starting
with ``_fused``, in modules under the port's scope (``repro_torch/`` by
default).  Everything reachable from a root through the call graph is
serving-hot; inside that set the following make the host wait for the
card (a device sync, a blocking copy, or both) and are flagged:

  * ``<expr>.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` and
    ``.synchronize()`` (a stream's, an event's, a device's);
  * ``torch.cuda.synchronize(...)``;
  * ``np.asarray(...)`` / ``np.array(...)`` / ``np.ascontiguousarray(...)``
    on the numpy module alias (on a CUDA tensor: a blocking copy);
  * ``float`` / ``int`` / ``bool`` applied to a call or a subscript
    (coercing a device value; a bare ``int(name)`` is too ambiguous to
    flag).

``.to("cpu")`` is left alone: its argument is rarely a literal.  The
counterpart of `repro/analysis/rules/host_sync.py`, which knows the JAX
idiom (``block_until_ready``, ``jax.device_get``).  Intentional host
stages — the single end-of-batch copy, request metadata crossing to the
card — carry ``# repro: allow-host: why``; `sanitizers.SyncCounter` checks
at run time that every sync of a route sits on such a line.
"""
from __future__ import annotations

import ast
from typing import List, Tuple

from ..core import Finding

#: module-path prefixes the rule applies to (config key ``host_sync_scope``)
DEFAULT_SCOPE: Tuple[str, ...] = ("repro_torch/",)

NP_ALIASES = {"np", "numpy"}
NP_FUNCS = {"asarray", "array", "ascontiguousarray"}
HOST_ATTRS = {"item", "cpu", "tolist", "numpy", "synchronize"}
COERCIONS = {"float", "int", "bool"}

ROOT_NAMES = {"route_fused", "serve_fused"}
ROOT_PREFIX = "_fused"


def is_root(name: str) -> bool:
    return name in ROOT_NAMES or name.startswith(ROOT_PREFIX)


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _sites(node: ast.AST):
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        fn = sub.func
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            if fn.attr in NP_FUNCS and isinstance(recv, ast.Name) \
                    and recv.id in NP_ALIASES:
                yield sub, f"{recv.id}.{fn.attr}"
            elif _dotted(fn) == "torch.cuda.synchronize":
                yield sub, "torch.cuda.synchronize"
            elif fn.attr in HOST_ATTRS and not sub.args:
                yield sub, f".{fn.attr}()"
        elif isinstance(fn, ast.Name) and fn.id in COERCIONS and sub.args \
                and isinstance(sub.args[0], (ast.Call, ast.Subscript)):
            yield sub, f"{fn.id}(...)"


def run(project, config) -> List[Finding]:
    scope = tuple(config.get("host_sync_scope", DEFAULT_SCOPE))
    roots = [f for f in project.all_funcs()
             if is_root(f.name) and f.module.relpath.startswith(scope)]
    reach = project.reachable(roots)
    findings = []
    for fn in reach.values():
        if not fn.module.relpath.startswith(scope):
            continue
        for site, what in _sites(fn.node):
            findings.append(Finding(
                rule="R1", path=fn.module.relpath, line=site.lineno,
                message=f"host sync `{what}` in `{fn.qualname}`, reachable "
                        f"from the fused serving roots"))
    return findings
