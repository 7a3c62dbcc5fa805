"""Shared lint-engine plumbing of the port: findings, pragmas, baseline
files (the port's own copy of `repro.analysis.core`, same syntax).

Pragma syntax (one per line, suppresses findings on that line and, when the
comment stands alone, on the next line):

    out = dev.cpu().numpy()  # repro: allow-host: single end-of-batch sync
    # repro: allow-jit-cache: captured once per object, guarded by is None
    y = self.delta_x         # repro: allow-unlocked: snapshot taken by caller

The justification after the second colon is REQUIRED — a bare pragma is
itself reported as a finding, so every suppression carries its reason in
the source.  The names and the rule-to-pragma map are the reference's, so
one justified pragma satisfies both packages' gates.

Baseline files hold one finding key per line (``rule|path|message``; line
numbers are deliberately excluded so unrelated edits don't invalidate the
baseline).  The shipped baseline is empty; the mechanism exists so a future
refactor can land with a temporary baseline instead of a flag day.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

PRAGMA_RE = re.compile(
    r"#\s*repro:\s*(?P<name>allow-[a-z-]+)\s*(?::\s*(?P<why>\S.*))?")

#: pragma name accepted by each rule
RULE_PRAGMA = {
    "R1": "allow-host",
    "R2": "allow-unlocked",
    "R4": "allow-jit-cache",
    "R5": "allow-swallow",
    "R6": "allow-plain-write",
}


@dataclass(frozen=True)
class Finding:
    rule: str          # "R1".."R6" or "PRAGMA"
    path: str          # posix path relative to the scan root's anchor
    line: int          # 1-based
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"

    @property
    def key(self) -> str:
        return f"{self.rule}|{self.path}|{self.message}"


class Pragmas:
    """Per-file pragma index: which lines each pragma name covers."""

    def __init__(self, source: str):
        self.lines: Dict[str, Set[int]] = {}
        self.bare: List[int] = []    # pragmas missing a justification
        for lineno, text in enumerate(source.splitlines(), start=1):
            m = PRAGMA_RE.search(text)
            if not m:
                continue
            if not m.group("why"):
                self.bare.append(lineno)
                continue
            cover = {lineno}
            if text[:m.start()].strip() == "":   # stand-alone comment line
                cover.add(lineno + 1)
            self.lines.setdefault(m.group("name"), set()).update(cover)

    def covers(self, name: Optional[str], lineno: int) -> bool:
        return name is not None and lineno in self.lines.get(name, ())


def load_baseline(path: Path) -> Set[str]:
    if not path.exists():
        return set()
    keys = set()
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            keys.add(line)
    return keys


def write_baseline(path: Path, findings: Iterable[Finding]) -> None:
    keys = sorted({f.key for f in findings})
    header = ("# Lint baseline — one `rule|path|message` key per line.\n"
              "# Regenerate with: python -m repro_torch.analysis.lint"
              " --write-baseline\n")
    # repro: allow-plain-write: dev-tool output, regenerate if ever torn
    path.write_text(header + "".join(k + "\n" for k in keys))
