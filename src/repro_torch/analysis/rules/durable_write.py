"""R6 — artifact, checkpoint and WAL writes go through the atomic helper.

Durability's whole contract (``repro_torch.persist``) is temp file → flush
→ fsync → ``os.replace`` → directory fsync.  A bare ``open(final, "w")``,
``np.savez(final_path)`` or ``torch.save(obj, final_path)`` anywhere in
the port can leave a torn file at the *final* name after a crash, which
recovery then loads as a corrupt checkpoint/manifest — exactly the failure
class the WAL and checkpoint store exist to rule out.  Flagged, in modules
under the port's scope (``repro_torch/`` by default,
``repro_torch/persist.py`` itself exempt since it is the helper):

  * ``open(..., mode)`` where the mode string writes (``w``/``a``/``x``
    or ``+``), including keyword ``mode=``;
  * ``np.save`` / ``np.savez`` / ``np.savez_compressed`` called with a
    path-like first argument, and ``torch.save(obj, f)`` with a path-like
    ``f`` (writing into an in-memory buffer such as ``io.BytesIO`` is
    fine — that is how the atomic helper itself is fed);
  * ``Path.write_text`` / ``Path.write_bytes``;
  * ``json.dump`` (use ``persist.atomic_write_json``).

Deliberate non-durable writes (append-only WAL segments, CLI report
output, build logs) carry ``# repro: allow-plain-write: why``.  The
counterpart of `repro/analysis/rules/durable_write.py`.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from ..core import Finding

#: module-path prefixes the rule applies to (config key ``durable_write_scope``)
DEFAULT_SCOPE: Tuple[str, ...] = ("repro_torch/",)
#: modules never flagged (config key ``durable_write_exempt``) — the
#: atomic helper itself has to perform the underlying plain writes.
DEFAULT_EXEMPT: Tuple[str, ...] = ("repro_torch/persist.py",)

_NP_WRITERS = {"save", "savez", "savez_compressed"}
_PATH_WRITERS = {"write_text", "write_bytes"}
_BUFFER_NAMES = ("buf", "buffer", "bio", "fh", "fileobj")


def _write_mode(call: ast.Call) -> Optional[str]:
    """The mode string of an ``open()`` call iff it writes, else None."""
    mode: Optional[ast.expr] = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return None  # default "r"
    if not isinstance(mode, ast.Constant) or not isinstance(mode.value, str):
        return None  # dynamic mode — can't prove a write
    if any(ch in mode.value for ch in "wax+"):
        return mode.value
    return None


def _is_buffer(node: Optional[ast.expr]) -> bool:
    """Heuristically true when ``node`` is an in-memory buffer
    (``io.BytesIO()`` / a name like ``buf``), not a path."""
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
        return name in ("BytesIO", "StringIO")
    if isinstance(node, ast.Name):
        return node.id in _BUFFER_NAMES
    return False


def _torch_save_target(call: ast.Call) -> Optional[ast.expr]:
    """The file argument of ``torch.save(obj, f)`` (positional or ``f=``)."""
    for kw in call.keywords:
        if kw.arg == "f":
            return kw.value
    return call.args[1] if len(call.args) >= 2 else None


def _finding(mod, node, message) -> Finding:
    return Finding(rule="R6", path=mod.relpath, line=node.lineno,
                   message=message)


def run(project, config) -> List[Finding]:
    scope = tuple(config.get("durable_write_scope", DEFAULT_SCOPE))
    exempt = tuple(config.get("durable_write_exempt", DEFAULT_EXEMPT))
    findings: List[Finding] = []
    for mod in project.modules:
        if not mod.relpath.startswith(scope) or mod.relpath in exempt:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            recv = fn.value.id if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) else None
            if isinstance(fn, ast.Name) and fn.id == "open":
                mode = _write_mode(node)
                if mode is not None:
                    findings.append(_finding(
                        mod, node,
                        f"`open(..., {mode!r})` writes to the final path — "
                        f"a crash mid-write leaves a torn file; use "
                        f"repro_torch.persist.atomic_write_* or justify "
                        f"with `# repro: allow-plain-write: <why>`"))
            elif not isinstance(fn, ast.Attribute):
                continue
            elif fn.attr in _NP_WRITERS and recv in ("np", "numpy") \
                    and not _is_buffer(node.args[0] if node.args else None):
                findings.append(_finding(
                    mod, node,
                    f"`np.{fn.attr}` to a path is not crash-atomic — use "
                    f"repro_torch.persist.atomic_savez (or write to an "
                    f"io.BytesIO and hand the bytes to the atomic helper)"))
            elif fn.attr == "save" and recv == "torch" \
                    and not _is_buffer(_torch_save_target(node)):
                findings.append(_finding(
                    mod, node,
                    "`torch.save` to a path is not crash-atomic — save into "
                    "an io.BytesIO and hand the bytes to "
                    "repro_torch.persist.atomic_write_bytes"))
            elif fn.attr in _PATH_WRITERS:
                findings.append(_finding(
                    mod, node,
                    f"`.{fn.attr}` writes the final path in place — use "
                    f"repro_torch.persist.atomic_write_text/bytes or "
                    f"justify with `# repro: allow-plain-write: <why>`"))
            elif fn.attr == "dump" and recv == "json":
                findings.append(_finding(
                    mod, node,
                    "`json.dump` to an open file is not crash-atomic — use "
                    "repro_torch.persist.atomic_write_json"))
    return findings
