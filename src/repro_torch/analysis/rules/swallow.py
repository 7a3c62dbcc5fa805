"""R5 — no bare/silent ``except`` in the port's serving tree.

The fault-tolerance layer's contract is "never a silent drop": every
serving-path failure must re-raise, be recorded (health stats / a
structured report / a log), or at minimum be handed to whoever is waiting
on it.  A handler that swallows the exception without doing any of those
turns an engine fault into exactly the lost-wave bug the circuit breaker
and reroute machinery exist to prevent.  Flagged, in modules under the
serving scope (``repro_torch/serving/`` by default):

  * bare ``except:`` — always (it also eats KeyboardInterrupt/SystemExit);
  * a handler whose body contains no ``raise``, makes no call at all, and
    never references the exception it bound — a pure swallow (``pass``,
    a bare ``continue``, ``x = None``...).

Re-raising, recording to health stats, stashing the exception for a
joining thread (``box["exc"] = exc``), and logging all pass.  Intentional
swallows carry ``# repro: allow-swallow: why``.  The counterpart of
`repro/analysis/rules/swallow.py`.
"""
from __future__ import annotations

import ast
from typing import List, Tuple

from ..core import Finding

#: module-path prefixes the rule applies to (config key ``swallow_scope``)
DEFAULT_SCOPE: Tuple[str, ...] = ("repro_torch/serving/",)


def _is_silent(handler: ast.ExceptHandler) -> bool:
    """True when the handler neither re-raises, nor calls anything, nor
    references the exception name it bound."""
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Call)):
            return False
        if (handler.name is not None and isinstance(node, ast.Name)
                and node.id == handler.name
                and isinstance(node.ctx, ast.Load)):
            return False
    return True


def run(project, config) -> List[Finding]:
    scope = tuple(config.get("swallow_scope", DEFAULT_SCOPE))
    findings: List[Finding] = []
    for mod in project.modules:
        if not mod.relpath.startswith(scope):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(Finding(
                    rule="R5", path=mod.relpath, line=node.lineno,
                    message="bare `except:` in the serving tree — it also "
                            "catches KeyboardInterrupt/SystemExit; catch a "
                            "typed exception and record or re-raise it"))
            elif _is_silent(node):
                caught = ast.unparse(node.type)
                findings.append(Finding(
                    rule="R5", path=mod.relpath, line=node.lineno,
                    message=f"`except {caught}` swallows the exception "
                            f"silently — re-raise, record it to health "
                            f"stats, or justify with "
                            f"`# repro: allow-swallow: <why>`"))
    return findings
