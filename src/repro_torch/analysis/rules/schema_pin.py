"""R3 — artifact-schema drift requires a ``FORMAT_VERSION`` bump (the port's
`repro_torch/core/routers`; the counterpart of
`repro/analysis/rules/schema_pin.py`).

`schema_pin.json` (beside this package's `lint.py`) pins, for the CURRENT
``FORMAT_VERSION``:

  * every router family's ``state_attrs`` tuple (the exact tensor set the
    npz round-trips), and
  * the manifest keys ``save_router`` writes.

A base that no ``@register`` names a family (the port's `NeighbourRouter`)
declares its ``state_attrs`` once for the families that derive from it:
when every direct subclass in the routers package inherits the tuple, it is
pinned under those subclasses' names, as the reference, which has no such
base, declares it on each.

Any drift in either — an attr added/removed/renamed, a manifest field
changed — while ``FORMAT_VERSION`` still equals the pinned version is a
finding: old artifacts would load into a router whose state contract
silently changed.  Bumping ``FORMAT_VERSION`` without refreshing the pin is
also a finding, so the bump and the new pin land in the same commit:

    python -m repro_torch.analysis.lint --update-schema-pin

Both packages read and write each other's artifacts, so the port's pin
equals the reference's `repro/analysis/schema_pin.json`.
"""
from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..core import Finding

ROUTERS_DIR = "repro_torch/core/routers"
PIN_NAME = "schema_pin.json"


def default_pin_path() -> Path:
    return Path(__file__).resolve().parent.parent / PIN_NAME


def _const_strings(node: ast.AST) -> Optional[List[str]]:
    if isinstance(node, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts):
        return [e.value for e in node.elts]
    return None


def _declared(node: ast.ClassDef) -> Optional[Tuple[List[str], int]]:
    """(state_attrs, line) if the class body assigns constant strings."""
    for item in node.body:
        if isinstance(item, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "state_attrs"
                for t in item.targets):
            value = item.value
        elif isinstance(item, ast.AnnAssign) and isinstance(
                item.target, ast.Name) and item.target.id == "state_attrs" \
                and item.value:
            value = item.value
        else:
            continue
        vals = _const_strings(value)
        if vals is not None:
            return vals, item.lineno
    return None


def _registered(node: ast.ClassDef) -> bool:
    """Whether an ``@register(...)`` decorator names the class a family."""
    for d in node.decorator_list:
        f = d.func if isinstance(d, ast.Call) else d
        if (isinstance(f, ast.Name) and f.id == "register") or (
                isinstance(f, ast.Attribute) and f.attr == "register"):
            return True
    return False


def extract_schema(project) -> Tuple[Optional[int], Dict[str, List[str]],
                                     List[str], Dict[str, int]]:
    """-> (format_version, {class: state_attrs}, manifest_fields, linenos)"""
    version = None
    classes: Dict[str, ast.ClassDef] = {}
    manifest: List[str] = []
    linenos: Dict[str, int] = {}
    for mod in project.modules:
        if ROUTERS_DIR not in mod.relpath:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                classes[node.name] = node
            elif isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "FORMAT_VERSION"
                    for t in node.targets):
                if isinstance(node.value, ast.Constant):
                    version = int(node.value.value)
                    linenos["FORMAT_VERSION"] = node.lineno
        if "artifacts" in mod.relpath:
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) and \
                        node.name == "save_router":
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Assign) and any(
                                isinstance(t, ast.Name) and
                                t.id == "manifest" for t in sub.targets) \
                                and isinstance(sub.value, ast.Dict):
                            manifest = [k.value for k in sub.value.keys
                                        if isinstance(k, ast.Constant)]
                            linenos["__manifest__"] = sub.lineno
    attrs: Dict[str, List[str]] = {}
    for name, node in classes.items():
        decl = _declared(node)
        if decl is None:
            continue
        heirs = [c for c, n in classes.items()
                 if any(isinstance(b, ast.Name) and b.id == name
                        for b in n.bases)]
        shared = not _registered(node) and heirs and all(
            _declared(classes[h]) is None for h in heirs)
        for owner in (heirs if shared else [name]):
            attrs[owner], linenos[owner] = decl
    return version, attrs, manifest, linenos


def current_schema(project) -> dict:
    version, attrs, manifest, _ = extract_schema(project)
    return {"format_version": version,
            "state_attrs": {k: list(v) for k, v in sorted(attrs.items())},
            "manifest_fields": sorted(manifest)}


def run(project, config) -> List[Finding]:
    pin_path = Path(config.get("schema_pin") or default_pin_path())
    version, attrs, manifest, linenos = extract_schema(project)
    if version is None:
        return []        # no artifacts module under this root: nothing to pin
    art_path = next((m.relpath for m in project.modules
                     if ROUTERS_DIR in m.relpath and
                     m.relpath.endswith("artifacts.py")), ROUTERS_DIR)
    if not pin_path.exists():
        return [Finding(
            rule="R3", path=art_path, line=linenos.get("FORMAT_VERSION", 1),
            message=f"schema pin `{pin_path.name}` missing — generate it "
                    f"with python -m repro_torch.analysis.lint "
                    f"--update-schema-pin")]
    pin = json.loads(pin_path.read_text())
    findings = []
    bump = ("bump FORMAT_VERSION and refresh the pin"
            if version == pin.get("format_version")
            else "refresh the pin (python -m repro_torch.analysis.lint "
                 "--update-schema-pin)")
    if version != pin.get("format_version"):
        findings.append(Finding(
            rule="R3", path=art_path, line=linenos.get("FORMAT_VERSION", 1),
            message=f"FORMAT_VERSION is {version} but the schema pin was "
                    f"taken at {pin.get('format_version')} — {bump}"))
    pinned_attrs = pin.get("state_attrs", {})
    for cls in sorted(set(pinned_attrs) | set(attrs)):
        got, want = attrs.get(cls), pinned_attrs.get(cls)
        if got != want:
            findings.append(Finding(
                rule="R3", path=art_path, line=linenos.get(cls, 1),
                message=f"`{cls}.state_attrs` drifted from the pinned "
                        f"schema ({want} -> {got}) — {bump}"))
    if sorted(manifest) != sorted(pin.get("manifest_fields", [])):
        findings.append(Finding(
            rule="R3", path=art_path, line=linenos.get("__manifest__", 1),
            message=f"artifact manifest fields drifted from the pinned "
                    f"schema — {bump}"))
    return findings
