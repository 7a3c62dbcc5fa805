"""The port's lint engine and its CLI: build the project index, run R1–R6
(`rules/`), apply pragmas and the baseline.

    PYTHONPATH=src python -m repro_torch.analysis.lint            # gate
    PYTHONPATH=src python -m repro_torch.analysis.lint --rules R1,R4
    PYTHONPATH=src python -m repro_torch.analysis.lint --update-schema-pin
    PYTHONPATH=src python -m repro_torch.analysis.lint --write-baseline

The gate exits 1 on any finding that is not baselined.  It has no ruff
tier: `scripts/lint_gate.py` runs ruff, and the reference's rules, over
all of ``src/``.  A root that is a package (holds ``__init__.py``, as the
default ``src/repro_torch`` does) is named with its package, so paths read
``repro_torch/...`` whether the root is ``src`` or ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .callgraph import Project, iter_py_files
from .core import Finding, RULE_PRAGMA, load_baseline, write_baseline
from .rules import ALL_RULES, schema_pin

_HERE = Path(__file__).resolve().parent
DEFAULT_ROOT = _HERE.parent
DEFAULT_BASELINE = _HERE / "lint_baseline.txt"


def build_project(root: Path) -> Project:
    root = Path(root)
    anchor = root.parent if (root / "__init__.py").exists() else root
    return Project(anchor, iter_py_files(root))


def lint_tree(project: Project, *, config: Optional[dict] = None,
              rules: Optional[Sequence[str]] = None
              ) -> Tuple[List[Finding], List[Finding]]:
    """-> (active findings, baselined findings), both pragma-filtered."""
    config = config or {}
    raw: List[Finding] = []
    for rule_id, rule_fn in ALL_RULES.items():
        if rules is not None and rule_id not in rules:
            continue
        raw.extend(rule_fn(project, config))

    pragmas: Dict[str, object] = {m.relpath: m.pragmas
                                  for m in project.modules}
    findings: List[Finding] = []
    for f in raw:
        pr = pragmas.get(f.path)
        if pr is not None and pr.covers(RULE_PRAGMA.get(f.rule), f.line):
            continue
        findings.append(f)

    # a pragma without a justification is itself a finding
    for relpath, pr in pragmas.items():
        for lineno in pr.bare:
            findings.append(Finding(
                rule="PRAGMA", path=relpath, line=lineno,
                message="`# repro: allow-*` pragma without a justification "
                        "(write `# repro: allow-host: <why>`)"))

    baseline = load_baseline(Path(config["baseline"])) \
        if config.get("baseline") else set()
    active = [f for f in findings if f.key not in baseline]
    suppressed = [f for f in findings if f.key in baseline]
    active.sort(key=lambda f: (f.path, f.line, f.rule))
    return active, suppressed


def lint_paths(root: Path, **kw) -> Tuple[List[Finding], List[Finding]]:
    return lint_tree(build_project(Path(root)), **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Lint the port (R1-R6) and fail on any finding that is "
                    "not baselined.")
    ap.add_argument("--root", default=str(DEFAULT_ROOT),
                    help="tree to lint (default: src/repro_torch)")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE))
    ap.add_argument("--schema-pin", default=None,
                    help="override the pinned-schema JSON path")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset, e.g. R1,R2")
    ap.add_argument("--update-schema-pin", action="store_true",
                    help="re-pin the current artifact schema and exit")
    ap.add_argument("--write-baseline", action="store_true",
                    help="baseline all current findings and exit")
    args = ap.parse_args(argv)

    project = build_project(Path(args.root))
    config = {"baseline": args.baseline, "schema_pin": args.schema_pin}

    if args.update_schema_pin:
        pin_path = Path(args.schema_pin or schema_pin.default_pin_path())
        # repro: allow-plain-write: dev-tool output, regenerated on demand
        pin_path.write_text(
            json.dumps(schema_pin.current_schema(project), indent=2) + "\n")
        print(f"schema pin refreshed: {pin_path}")
        return 0

    rules = args.rules.split(",") if args.rules else None
    active, suppressed = lint_tree(project, config=config, rules=rules)

    if args.write_baseline:
        write_baseline(Path(args.baseline), active + suppressed)
        print(f"baselined {len(active) + len(suppressed)} finding(s): "
              f"{args.baseline}")
        return 0

    for f in active:
        print(f.render())
    print(f"repro_torch.analysis.lint: {len(active)} finding(s) over "
          f"{len(project.modules)} file(s) ({len(suppressed)} baselined)")
    return 1 if active else 0


if __name__ == "__main__":
    raise SystemExit(main())
