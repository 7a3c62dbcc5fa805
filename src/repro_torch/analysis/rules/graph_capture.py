"""R4 — CUDA-graph and compile-cache hygiene (the port's counterpart of
`repro/analysis/rules/jit_cache.py`).

The port has no ``jax.jit``: its caches of compiled work are captured CUDA
graphs (`core/routers/nn_utils._GraphedStep`) and, were one used,
``torch.compile``'s.  Three classes of bug defeat them silently:

  * a capture built in a function body and not kept behind an ``is None``
    guard of a stored slot (``torch.cuda.CUDAGraph()`` or a
    ``with torch.cuda.graph(...)`` outside ``if self.graph is None:``):
    every call captures afresh — the counterpart of an inline
    ``jax.jit`` that rebuilds its cache per call;
  * a captured body that reads ``self.<attr>`` when a method other than
    ``__init__`` rebinds that attribute: a replay reads the tensor the
    capture saw, so the rebind is silently ignored — the counterpart of a
    jitted closure over mutable instance state;
  * ``torch.compile(...)`` (a call or a decorator) inside a function body:
    a fresh compile cache per call.

Module level and ``__init__`` (once per object) are exempt; deliberately
scoped captures carry ``# repro: allow-jit-cache: why`` (the reference's
pragma name, so one pragma serves both gates).  Only modules under the
port's scope (``repro_torch/`` by default) are checked.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from ..callgraph import parent_map
from ..core import Finding

#: module-path prefixes the rule applies to (config key ``graph_scope``)
DEFAULT_SCOPE: Tuple[str, ...] = ("repro_torch/",)
EXEMPT_METHODS = {"__init__"}


def _tail(node: ast.AST) -> str:
    """``a.b.c`` -> ``"b.c"`` (the last two parts), ``f`` -> ``"f"``."""
    if isinstance(node, ast.Attribute):
        inner = node.value
        head = inner.attr if isinstance(inner, ast.Attribute) else (
            inner.id if isinstance(inner, ast.Name) else "")
        return f"{head}.{node.attr}"
    return node.id if isinstance(node, ast.Name) else ""


def _is_capture(call: ast.AST) -> bool:
    return isinstance(call, ast.Call) and _tail(call.func) in (
        "cuda.CUDAGraph", "CUDAGraph", "cuda.graph")


def _is_compile(node: ast.AST) -> bool:
    fn = node.func if isinstance(node, ast.Call) else node
    return _tail(fn) == "torch.compile"


def _guarded(node: ast.AST, parents: Dict[ast.AST, ast.AST],
             globals_: Set[str]) -> bool:
    """Inside the body of an ``if <slot> is None:`` whose slot is stored
    beyond the call (an attribute, a subscript, a global name)."""
    child, cur = node, parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.If) and child in cur.body:
            for cmp in ast.walk(cur.test):
                if isinstance(cmp, ast.Compare) and any(
                        isinstance(op, ast.Is) for op in cmp.ops) and any(
                        isinstance(c, ast.Constant) and c.value is None
                        for c in cmp.comparators):
                    slot = cmp.left
                    if isinstance(slot, (ast.Attribute, ast.Subscript)) or (
                            isinstance(slot, ast.Name)
                            and slot.id in globals_):
                        return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        child, cur = cur, parents.get(cur)
    return False


def _rebound_outside_init(cls_node: ast.ClassDef) -> Set[str]:
    """Attributes ``self.<a>`` assigned by a method other than __init__."""
    out: Set[str] = set()
    for item in cls_node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or item.name in EXEMPT_METHODS:
            continue
        for sub in ast.walk(item):
            if isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Store) \
                    and isinstance(sub.value, ast.Name) \
                    and sub.value.id == "self":
                out.add(sub.attr)
    return out


def run(project, config) -> List[Finding]:
    scope = tuple(config.get("graph_scope", DEFAULT_SCOPE))
    findings: List[Finding] = []
    for mod in project.modules:
        if not mod.relpath.startswith(scope):
            continue
        parents = parent_map(mod.tree)
        classes = {n.name: n for n in mod.tree.body
                   if isinstance(n, ast.ClassDef)}
        for fn in list(mod.funcs.values()) + [
                m for c in mod.classes.values() for m in c.values()]:
            rebound = (_rebound_outside_init(classes[fn.cls])
                       if fn.cls in classes else set())
            globals_ = {n for sub in ast.walk(fn.node)
                        if isinstance(sub, (ast.Global, ast.Nonlocal))
                        for n in sub.names}
            decorators = {d for sub in ast.walk(fn.node)
                          if isinstance(sub, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                          for d in sub.decorator_list}
            for sub in ast.walk(fn.node):
                # a captured body reading state a later method rebinds
                if isinstance(sub, ast.With) and any(
                        _is_capture(i.context_expr) for i in sub.items):
                    for stmt in sub.body:
                        for n in ast.walk(stmt):
                            if isinstance(n, ast.Attribute) \
                                    and isinstance(n.ctx, ast.Load) \
                                    and isinstance(n.value, ast.Name) \
                                    and n.value.id == "self" \
                                    and n.attr in rebound:
                                findings.append(Finding(
                                    rule="R4", path=mod.relpath,
                                    line=n.lineno,
                                    message=f"captured CUDA graph in "
                                            f"`{fn.qualname}` reads "
                                            f"`self.{n.attr}`, which a "
                                            f"method other than __init__ "
                                            f"rebinds — a replay reads the "
                                            f"tensor of the capture"))
                if fn.name in EXEMPT_METHODS or sub is fn.node:
                    continue
                if _is_capture(sub) and not _guarded(sub, parents, globals_):
                    findings.append(Finding(
                        rule="R4", path=mod.relpath, line=sub.lineno,
                        message=f"CUDA graph capture `{ast.unparse(sub.func)}"
                                f"(...)` in `{fn.qualname}` outside an "
                                f"`is None` guard of a stored slot — a "
                                f"fresh capture on every call"))
                elif isinstance(sub, ast.Call) and _is_compile(sub) \
                        and sub not in decorators:
                    findings.append(Finding(
                        rule="R4", path=mod.relpath, line=sub.lineno,
                        message=f"inline `torch.compile(...)` inside "
                                f"`{fn.qualname}` — the compile cache is "
                                f"rebuilt on every call unless cached by "
                                f"hand"))
                elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and any(_is_compile(d) for d in sub.decorator_list):
                    findings.append(Finding(
                        rule="R4", path=mod.relpath, line=sub.lineno,
                        message=f"`@torch.compile` def `{sub.name}` nested "
                                f"inside `{fn.qualname}` — a fresh compile "
                                f"cache per call"))
    return findings
