"""R2 — lock discipline on the port's ``DynamicIVFIndex`` mutable state.

The index mutates under a single ``threading.RLock`` (``self._lock``); a
search takes its snapshot under it (`DynamicIVFIndex.fused_state`) and
computes outside it.  This rule makes the convention mechanical:

  * inside the class, every load/store of a guarded field (``base``,
    ``delta_x``, ``delta_assign``, ``appends``, ``reclusters``, ``_buf``,
    ``_snap``) must sit lexically inside ``with self._lock:``
    (``__init__`` is exempt — the object is not yet shared);
  * everywhere else, touching a distinctively-named mutable field
    (``delta_x``, ``delta_assign``, ``_buf``, ``_snap``) on ANY receiver,
    or ``.base`` in a function that references ``DynamicIVFIndex``,
    requires ``with <receiver>._lock:``.

Lock state does NOT flow into nested ``def``/``lambda`` bodies — a closure
may execute on another thread after the ``with`` exits — so code inside
them must re-acquire.  Intentional unlocked access (e.g. a snapshot taken
by the caller under the lock) carries ``# repro: allow-unlocked: why``.
Only modules under the port's scope (``repro_torch/`` by default) are
checked.  The counterpart of `repro/analysis/rules/lock_discipline.py`,
whose ``_fused`` / ``_flat_buf`` are the port's ``_snap`` / ``_buf``.
"""
from __future__ import annotations

import ast
from typing import List, Set, Tuple

from ..core import Finding

#: module-path prefixes the rule applies to (config key ``lock_scope``)
DEFAULT_SCOPE: Tuple[str, ...] = ("repro_torch/",)
CLASS_NAME = "DynamicIVFIndex"
GUARDED = {"base", "delta_x", "delta_assign", "appends", "reclusters",
           "_buf", "_snap"}
DISTINCTIVE = {"delta_x", "delta_assign", "_buf", "_snap"}
EXEMPT_METHODS = {"__init__"}


def _lock_receivers(with_node: ast.With) -> Set[str]:
    out = set()
    for item in with_node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Attribute) and expr.attr == "_lock" \
                and isinstance(expr.value, ast.Name):
            out.add(expr.value.id)
    return out


def _check(node: ast.AST, locked: Set[str], internal: bool,
           want_base: bool, hits: List[ast.Attribute]) -> None:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        locked = set()          # closures may outlive the with block
    if isinstance(node, ast.With):
        locked = locked | _lock_receivers(node)
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        recv, attr = node.value.id, node.attr
        if internal and recv == "self":
            if attr in GUARDED and recv not in locked:
                hits.append(node)
        elif not internal and recv != "self":
            if (attr in DISTINCTIVE or (want_base and attr == "base")) \
                    and recv not in locked:
                hits.append(node)
    for child in ast.iter_child_nodes(node):
        _check(child, locked, internal, want_base, hits)


def run(project, config) -> List[Finding]:
    scope = tuple(config.get("lock_scope", DEFAULT_SCOPE))
    findings = []
    for fn in project.all_funcs():
        if not fn.module.relpath.startswith(scope):
            continue
        internal = fn.cls == CLASS_NAME
        if internal and fn.name in EXEMPT_METHODS:
            continue
        want_base = not internal and any(
            isinstance(n, ast.Name) and n.id == CLASS_NAME
            for n in ast.walk(fn.node))
        hits: List[ast.Attribute] = []
        for stmt in getattr(fn.node, "body", []):
            _check(stmt, set(), internal, want_base, hits)
        for node in hits:
            where = "" if internal else f" of a {CLASS_NAME}"
            findings.append(Finding(
                rule="R2", path=fn.module.relpath, line=node.lineno,
                message=f"`{ast.unparse(node)}`{where} accessed outside "
                        f"`with ..._lock` in `{fn.qualname}`"))
    return findings
