"""Runtime sanitizers of the port — the dynamic counterparts of the R1/R4
lint rules (`repro.analysis.sanitizers` is the reference's; this module
imports no ``jax``, and ``torch`` only inside the calls that need it).

* `SyncCounter` — the counterpart of ``no_implicit_transfers``: a context
  manager that puts ``torch.cuda.set_sync_debug_mode("warn")`` over a
  block and records, for every synchronizing CUDA call inside it (a
  blocking copy to or from the card, an ``.item()``, a stream wait), the
  innermost frame of the port's package as ``path:line``.  The mode is
  process-wide, so the block should run with no other thread using the
  card.  `allowed_by_pragma` keeps the records whose line carries no
  ``# repro: allow-host: why`` pragma — the syncs the R1 gate would not
  have let through.

* `CacheCounter` — the counterpart of ``RetraceCounter``: snapshots the
  sizes of the port's caches (`port_caches`: the kernel libraries loaded,
  the CUDA graphs captured, each router's device copies) and reports any
  growth.  Waves of one (index kind, batch size) cell must not grow any
  of them after the first.

* `run_with_watchdog` — an interleaving harness for the streaming index's
  append / recluster / query surface: worker threads run concurrently
  under a deadline; on a hang the watchdog raises `DeadlockError` carrying
  every thread's live stack instead of letting CI time out silently.
"""
from __future__ import annotations

import ast
import sys
import threading
import time
import traceback
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .core import Pragmas

#: the directory that holds the port's package: records' paths are
#: relative to it (``repro_torch/...``), as the lint's findings are
SRC_ROOT = Path(__file__).resolve().parents[2]
_PACKAGE = SRC_ROOT / "repro_torch"
_SYNC_MARK = "synchronizing CUDA operation"


@dataclass(frozen=True)
class SyncRecord:
    path: str          # repro_torch/... (or the innermost file, outside it)
    line: int
    message: str

    @property
    def site(self) -> str:
        return f"{self.path}:{self.line}"


def _port_frame(frame) -> Tuple[str, int]:
    """(path, line) of the innermost frame inside the port's package, else
    of the innermost frame outside the warnings machinery."""
    first = None
    while frame is not None:
        fname = Path(frame.f_code.co_filename)
        if first is None and fname.name != "warnings.py":
            first = (str(fname), frame.f_lineno)
        try:
            rel = fname.resolve().relative_to(_PACKAGE)
        except (ValueError, OSError):
            frame = frame.f_back
            continue
        return f"repro_torch/{rel.as_posix()}", frame.f_lineno
    return first or ("?", 0)


class SyncCounter:
    """Record every synchronizing CUDA call made inside the block.

        with SyncCounter() as sc:
            svc.route_fused(emb, lams)
        sc.by_site()            # {"repro_torch/...:534": 5, ...}
        allowed_by_pragma(sc.records)   # [] when every sync is justified

    Other warnings raised inside the block reach the previous handler."""

    def __init__(self):
        self.records: List[SyncRecord] = []

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        if _SYNC_MARK not in str(message):
            self._show(message, category, filename, lineno, file, line)
            return
        path, ln = _port_frame(sys._getframe(1))
        self.records.append(SyncRecord(path, ln, str(message).split("\n")[0]))

    def __enter__(self) -> "SyncCounter":
        import torch
        self._torch = torch
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        self._show = warnings.showwarning
        warnings.simplefilter("always")
        warnings.showwarning = self._hook
        self._prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc) -> None:
        try:
            self._torch.cuda.set_sync_debug_mode(self._prev)
        finally:
            self._catch.__exit__(*exc)

    def by_site(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.site] = out.get(r.site, 0) + 1
        return out


def _index(path: Path) -> Tuple[Pragmas, List[Tuple[int, int]]]:
    """A file's pragmas and the (first, last) lines of its simple
    statements."""
    source = path.read_text()
    spans = [(n.lineno, n.end_lineno) for n in ast.walk(ast.parse(source))
             if isinstance(n, ast.stmt) and not hasattr(n, "body")]
    return Pragmas(source), spans


def allowed_by_pragma(records: Sequence[SyncRecord],
                      root: Optional[Path] = None) -> List[SyncRecord]:
    """The records that sit on no ``allow-host`` line: neither their line
    nor the first line of the simple statement holding it (where R1
    reports a call that spans lines) carries the pragma, or no file of the
    port holds them.  ``root`` is the directory holding ``repro_torch``."""
    root = Path(root) if root is not None else SRC_ROOT
    bad, files = [], {}
    for r in records:
        path = root / r.path
        if not r.path.startswith("repro_torch/") or not path.exists():
            bad.append(r)
            continue
        if path not in files:
            files[path] = _index(path)
        pragmas, spans = files[path]
        starts = [a for a, b in spans if a <= r.line <= b]
        lines = {r.line} | ({max(starts)} if starts else set())
        if not any(pragmas.covers("allow-host", ln) for ln in lines):
            bad.append(r)
    return bad


def _dev_bytes(router) -> int:
    """Bytes of the device tensors a router keeps in ``_dev``."""
    import torch
    n = 0
    for v in getattr(router, "_dev", {}).values():
        for t in (v if isinstance(v, tuple) else (v,)):
            if isinstance(t, torch.Tensor):
                n += t.numel() * t.element_size()
    return n


def port_caches(routers: Optional[Dict[str, object]] = None
                ) -> Dict[str, Callable[[], int]]:
    """The port's caches as ``{name: size()}``: kernel libraries loaded
    (`kernels._build`), CUDA graphs captured (`nn_utils._GraphedStep`),
    and each named router's device copies (bytes held in its ``_dev``)."""
    from repro_torch.core.routers import nn_utils
    from repro_torch.kernels import _build
    sizes: Dict[str, Callable[[], int]] = {
        "kernel_libraries": lambda: len(_build._libs),
        "cuda_graphs": lambda: nn_utils._GraphedStep.captures}
    for name, r in (routers or {}).items():
        sizes[f"router_dev_bytes[{name}]"] = lambda r=r: _dev_bytes(r)
    return sizes


@dataclass
class CacheCounter:
    """Tracks the sizes of named caches between checkpoints.

        cc = CacheCounter(port_caches({"knn10": router}))
        cc.snapshot()
        ... repeated waves ...
        assert cc.growth() == {}          # nothing new cached
    """
    sizes: Dict[str, Callable[[], int]]
    _base: Dict[str, int] = field(default_factory=dict)

    def snapshot(self) -> Dict[str, int]:
        self._base = {name: int(fn()) for name, fn in self.sizes.items()}
        return dict(self._base)

    def growth(self) -> Dict[str, int]:
        """{name: growth since snapshot()} — empty means stable."""
        out = {}
        for name, fn in self.sizes.items():
            delta = int(fn()) - self._base.get(name, 0)
            if delta:
                out[name] = delta
        return out

    def total(self) -> int:
        return sum(self.growth().values())


class DeadlockError(AssertionError):
    pass


def _live_stacks() -> str:
    frames = sys._current_frames()
    lines = []
    for t in threading.enumerate():
        frame = frames.get(t.ident)
        lines.append(f"--- {t.name} (daemon={t.daemon}) ---")
        if frame is not None:
            lines.extend(traceback.format_stack(frame))
    return "".join(lines)


def run_with_watchdog(workers: Sequence[Callable[[], None]], *,
                      timeout: float = 60.0) -> None:
    """Run ``workers`` concurrently; raise `DeadlockError` with a full
    all-thread stack dump if they have not ALL finished within ``timeout``
    seconds.  Worker exceptions are re-raised in the caller."""
    errors: List[BaseException] = []
    err_lock = threading.Lock()

    def wrap(fn):
        def runner():
            try:
                fn()
            except BaseException as exc:     # noqa: BLE001 — re-raised below
                with err_lock:
                    errors.append(exc)
        return runner

    threads = [threading.Thread(target=wrap(fn), daemon=True,
                                name=f"watchdog-worker-{i}")
               for i, fn in enumerate(workers)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            raise DeadlockError(
                f"interleaving harness hung (> {timeout:.0f}s); live "
                f"stacks:\n{_live_stacks()}")
    if errors:
        raise errors[0]
