"""Project-wide AST index + a conservative call-graph walk (the port's own
copy of `repro.analysis.callgraph`: pure `ast`, nothing imported from it).

Resolution is heuristic but deliberately biased toward OVER-approximating
reachability (R1 would rather flag a host sync that needs a pragma than
miss one):

  * ``self.m()`` / ``cls.m()`` resolves inside the caller's class first,
    then to a unique project-wide definition of ``m``;
  * bare ``f()`` resolves in the caller's module, then through its
    ``from X import f`` imports, then to a unique project-wide ``f``;
  * ``obj.m()`` resolves only when ``m`` is defined exactly once across the
    project AND is not a ubiquitous name (``append``, ``get``, ...), so
    stdlib/np method calls don't pull unrelated code into the walk.

Nested ``def``s and lambdas are folded into their enclosing function: their
bodies are scanned (and their calls followed) as part of the parent, which
keeps closures visible to the walk without polluting the global name index.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .core import Pragmas

#: names too generic to resolve through a bare ``obj.m()`` receiver
COMMON_NAMES = {
    "append", "extend", "insert", "remove", "pop", "clear", "index",
    "get", "items", "keys", "values", "update", "setdefault", "add",
    "join", "split", "strip", "startswith", "endswith", "format", "encode",
    "decode", "read", "write", "open", "close", "flush", "copy", "sort",
    "astype", "reshape", "tolist", "item", "mean", "sum", "min", "max",
    "put", "result", "submit", "acquire", "release", "start", "run",
    "exists", "mkdir", "lower", "upper", "count", "replace", "search",
    "match", "group", "fit", "select", "save", "load",
}


@dataclass
class FuncInfo:
    name: str
    cls: Optional[str]
    node: ast.AST                       # FunctionDef / AsyncFunctionDef
    module: "ModuleInfo"
    calls: List[Tuple[str, str]] = field(default_factory=list)

    @property
    def qualname(self) -> str:
        owner = f"{self.cls}." if self.cls else ""
        return f"{self.module.relpath}::{owner}{self.name}"


@dataclass
class ModuleInfo:
    relpath: str                        # posix path relative to the scan root
    path: Path
    source: str
    tree: ast.Module
    pragmas: Pragmas
    funcs: Dict[str, FuncInfo] = field(default_factory=dict)
    classes: Dict[str, Dict[str, FuncInfo]] = field(default_factory=dict)
    imports: Dict[str, str] = field(default_factory=dict)  # local -> module


def _collect_calls(node: ast.AST) -> List[Tuple[str, str]]:
    out = []
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        fn = sub.func
        if isinstance(fn, ast.Name):
            out.append(("bare", fn.id))
        elif isinstance(fn, ast.Attribute):
            recv = fn.value
            if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
                out.append(("self", fn.attr))
            else:
                out.append(("attr", fn.attr))
    return out


class Project:
    def __init__(self, root: Path, files: List[Path]):
        self.root = root
        self.modules: List[ModuleInfo] = []
        self.by_name: Dict[str, List[FuncInfo]] = {}
        for path in files:
            source = path.read_text()
            try:
                tree = ast.parse(source, filename=str(path))
            except SyntaxError:
                continue
            mod = ModuleInfo(
                relpath=path.relative_to(root).as_posix(), path=path,
                source=source, tree=tree, pragmas=Pragmas(source))
            self._index_module(mod)
            self.modules.append(mod)

    def _register(self, mod: ModuleInfo, node, cls: Optional[str]) -> None:
        info = FuncInfo(name=node.name, cls=cls, node=node, module=mod,
                        calls=_collect_calls(node))
        if cls is None:
            mod.funcs[node.name] = info
        else:
            mod.classes.setdefault(cls, {})[node.name] = info
        self.by_name.setdefault(node.name, []).append(info)

    def _index_module(self, mod: ModuleInfo) -> None:
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._register(mod, node, cls=None)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._register(mod, item, cls=node.name)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    mod.imports[alias.asname or alias.name] = node.module

    # ---- resolution ----
    def _unique(self, name: str) -> List[FuncInfo]:
        cands = self.by_name.get(name, [])
        if len(cands) == 1 and name not in COMMON_NAMES:
            return cands
        return []

    def resolve(self, caller: FuncInfo, kind: str,
                name: str) -> List[FuncInfo]:
        mod = caller.module
        if kind == "self" and caller.cls:
            hit = mod.classes.get(caller.cls, {}).get(name)
            if hit is not None:
                return [hit]
            return self._unique(name)
        if kind == "bare":
            if name in mod.funcs:
                return [mod.funcs[name]]
            if name in mod.imports:
                target = mod.imports[name]
                for other in self.modules:
                    stem = other.relpath[:-3].replace("/", ".")
                    if stem.endswith(target.lstrip(".")) and \
                            name in other.funcs:
                        return [other.funcs[name]]
            return self._unique(name)
        return self._unique(name)   # "attr" / "self" outside a known class

    def reachable(self, roots: List[FuncInfo]) -> Dict[str, FuncInfo]:
        seen: Dict[str, FuncInfo] = {}
        frontier = list(roots)
        while frontier:
            fn = frontier.pop()
            if fn.qualname in seen:
                continue
            seen[fn.qualname] = fn
            for kind, name in fn.calls:
                frontier.extend(self.resolve(fn, kind, name))
        return seen

    def all_funcs(self) -> List[FuncInfo]:
        return [f for funcs in self.by_name.values() for f in funcs]


def iter_py_files(root: Path) -> List[Path]:
    return sorted(p for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents
