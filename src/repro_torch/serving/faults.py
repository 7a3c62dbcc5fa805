"""Fault-tolerance primitives of the port's serving stack (mirrors
`repro.serving.faults`): per-engine health tracking with circuit breakers,
typed overload/shed errors, a degradation ladder for deadline-driven
retrieval, and a fault injector for chaos tests.

A kNN router already computes utility estimates over the WHOLE model pool
per request, so when the argmax model is down the next-best model is
already sitting in ``s_hat``: robustness is a masked selection plus a
deterministic reroute, not an exception handler outside the hot path.

Pieces (wired together by `RouterService` / `MicroBatcher`):

* `EngineHealth` — a per-engine circuit breaker: ``closed`` while the
  engine serves, ``open`` after ``failure_threshold`` consecutive
  failures/timeouts, ``half_open`` after an exponential backoff elapses
  (the next wave is the probe; one success re-closes the breaker, a failed
  probe re-opens it with a doubled backoff).  ``stats()`` is the JSON-ready
  dict the gateway's ``/health`` endpoint serves.
* `Overloaded` / `CircuitOpenError` / `EngineDeadlineExceeded` /
  `InjectedFault` / `FeedbackValidationError` — typed errors.  Load shedding is always
  reject-with-retry-after, never a silent drop.
* `DegradationLadder` — maps (queue depth, deadline headroom) to a
  retrieval degradation level: shrink ``nprobe``, drop the exact re-rank
  tier, skip the streaming delta merge.  Each served response is annotated
  with the level it was served at (`RoutedResult.degradation`).
* `FaultInjector` — wraps any `ServingEngine` and injects ``raise`` /
  ``hang`` / ``latency`` / ``flaky`` faults at the ``run_until_drained``
  boundary; everything else delegates.
* `ExecutionReport` — `RouterService.execute`'s return type: the
  ``{model: decode_steps}`` dict plus the per-model error report, the
  reroute trail and the shed list.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .engine import ServingEngine

# ---------------------------------------------------------------------------
# typed errors — shedding and skipping are never silent
# ---------------------------------------------------------------------------


class Overloaded(RuntimeError):
    """Admission rejected: the bounded queue is full.  Carries a
    ``retry_after_s`` hint (estimated time for the backlog to drain one
    wave) so clients can back off instead of hammering."""

    def __init__(self, msg: str, *, retry_after_s: float, pending: int):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.pending = int(pending)


class CircuitOpenError(RuntimeError):
    """An engine was skipped because its breaker is open."""

    def __init__(self, model: str, *, retry_after_s: float):
        super().__init__(f"circuit open for engine {model!r}; retry in "
                         f"{retry_after_s:.2f}s")
        self.model = model
        self.retry_after_s = float(retry_after_s)


class EngineDeadlineExceeded(RuntimeError):
    """An engine did not drain its wave within the service deadline — the
    hung-engine signal that opens the breaker without blocking the serving
    loop forever."""

    def __init__(self, model: str, timeout_s: float):
        super().__init__(f"engine {model!r} exceeded its {timeout_s:.2f}s "
                         f"execution deadline")
        self.model = model
        self.timeout_s = float(timeout_s)


class FeedbackValidationError(ValueError):
    """An ``observe()`` batch failed validation BEFORE the write-ahead log:
    an empty batch, non-finite embeddings / scores / costs, or a shape
    that does not match the fitted model axis.  Raised before the WAL
    write, so garbage never becomes durable state that every recovery
    would replay.  A ValueError, carrying the offending ``field``."""

    def __init__(self, field: str, message: str):
        super().__init__(message)
        self.field = field


class InjectedFault(RuntimeError):
    """Raised by `FaultInjector` — distinguishable from organic failures in
    chaos-test assertions."""


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class EngineHealth:
    """Per-engine circuit-breaker state machine.

    closed --(failure_threshold consecutive failures)--> open
    open   --(backoff elapsed; next request is the probe)--> half_open
    half_open --success--> closed        (failure streak + backoff reset)
    half_open --failure--> open          (backoff doubles, up to the cap)

    ``available()`` is the serving-side gate: it performs the open ->
    half_open transition lazily when the backoff has elapsed, so no timer
    thread exists anywhere.  All transitions happen under a lock — waves
    for different engines may be executed from worker threads."""

    def __init__(self, name: str, *, failure_threshold: int = 3,
                 base_backoff_s: float = 0.5, max_backoff_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got "
                             f"{failure_threshold}")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self.consecutive_failures = 0
        self.open_streak = 0          # consecutive opens -> backoff exponent
        self.opened_at = 0.0
        self.successes = 0
        self.failures = 0
        self.timeouts = 0
        self.opens = 0
        self.probes = 0
        self.last_error: Optional[str] = None

    # ---- queries ----
    @property
    def backoff_s(self) -> float:
        """Current open-state backoff: base * 2^(streak-1), capped."""
        exp = max(self.open_streak - 1, 0)
        return min(self.base_backoff_s * (2.0 ** exp), self.max_backoff_s)

    def available(self) -> bool:
        """Whether the next wave may be dispatched to this engine.  In the
        open state this transitions to half_open once the backoff has
        elapsed (the caller's wave becomes the probe)."""
        with self._lock:
            if self.state == OPEN:
                if self.clock() - self.opened_at >= self.backoff_s:
                    self.state = HALF_OPEN
                    self.probes += 1
                else:
                    return False
            return True

    def retry_after_s(self) -> float:
        """Seconds until the breaker would let a probe through (0 when it
        already would)."""
        with self._lock:
            if self.state != OPEN:
                return 0.0
            return max(self.backoff_s - (self.clock() - self.opened_at), 0.0)

    # ---- transitions ----
    def record_success(self) -> None:
        with self._lock:
            self.successes += 1
            self.consecutive_failures = 0
            if self.state in (HALF_OPEN, OPEN):
                self.open_streak = 0         # recovery resets the backoff
            self.state = CLOSED

    def record_failure(self, exc: BaseException) -> None:
        """Count a failure; open (or re-open, with doubled backoff) when
        the threshold is crossed or a half-open probe fails."""
        with self._lock:
            self.failures += 1
            self.consecutive_failures += 1
            if isinstance(exc, EngineDeadlineExceeded):
                self.timeouts += 1
            self.last_error = f"{type(exc).__name__}: {exc}"
            failed_probe = self.state == HALF_OPEN
            if failed_probe or (
                    self.state == CLOSED
                    and self.consecutive_failures >= self.failure_threshold):
                self.state = OPEN
                self.open_streak += 1
                self.opens += 1
                self.opened_at = self.clock()

    # ---- reporting ----
    def stats(self) -> Dict:
        """JSON-ready health snapshot (the gateway's ``/health`` payload
        for this engine)."""
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "successes": self.successes,
                "failures": self.failures,
                "timeouts": self.timeouts,
                "opens": self.opens,
                "probes": self.probes,
                "backoff_s": round(self.backoff_s, 6),
                "last_error": self.last_error,
            }


# ---------------------------------------------------------------------------
# degradation ladder — deadline-driven retrieval downshifts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DegradationLevel:
    """One rung: retrieval-parameter overrides applied for a wave.

    ``nprobe_scale`` shrinks the probe set; ``rerank`` overrides the exact
    re-rank budget (0 drops the tier entirely, None keeps the router's);
    ``skip_delta`` serves from the compacted base only, giving up rows
    still in the streaming delta tier."""
    level: int
    name: str
    nprobe_scale: float = 1.0
    rerank: Optional[int] = None
    skip_delta: bool = False


#: the default ladder: full fidelity -> shrink the probe set -> drop the
#: exact re-rank tier -> serve the compacted base only
DEFAULT_LEVELS: Tuple[DegradationLevel, ...] = (
    DegradationLevel(0, "full"),
    DegradationLevel(1, "reduced-probe", nprobe_scale=0.5),
    DegradationLevel(2, "no-rerank", nprobe_scale=0.5, rerank=0),
    DegradationLevel(3, "base-only", nprobe_scale=0.25, rerank=0,
                     skip_delta=True),
)


@dataclasses.dataclass
class DegradationLadder:
    """Selects a degradation level per wave from queue depth and deadline
    headroom.  Thresholds are deterministic and documented here, not
    learned: each rung trades a bounded amount of recall (see
    ``tests/test_faults.py::test_degraded_ladder_recall_floor``) for a
    hard latency reduction, so the ladder only engages under pressure.

    ``headroom`` is the remaining fraction of the oldest queued request's
    deadline (1.0 = fresh, <= 0 = already overdue); ``depth_waves`` is the
    backlog measured in full waves (queue depth / max_batch)."""

    levels: Tuple[DegradationLevel, ...] = DEFAULT_LEVELS
    #: (min_headroom, min_depth_waves) per rung above 0: crossing EITHER
    #: threshold engages that rung
    thresholds: Tuple[Tuple[float, float], ...] = (
        (0.5, 2.0), (0.25, 4.0), (0.1, 8.0))

    def level_for(self, queue_depth: int, max_batch: int,
                  headroom: float = 1.0) -> int:
        depth_waves = queue_depth / max(max_batch, 1)
        level = 0
        for i, (min_head, min_depth) in enumerate(self.thresholds, start=1):
            if i >= len(self.levels):
                break
            if headroom < min_head or depth_waves > min_depth:
                level = i
        return level

    def __getitem__(self, level: int) -> DegradationLevel:
        return self.levels[min(max(int(level), 0), len(self.levels) - 1)]


# ---------------------------------------------------------------------------
# execution report — partial results with structured per-model errors
# ---------------------------------------------------------------------------


class ExecutionReport(dict):
    """``{model: decode_steps}`` for the engines that served (the mapping
    `RouterService.execute` has always returned), plus the fault surface:

    * ``errors`` — ``{model: [structured error dicts]}`` for every engine
      failure that was isolated (the wave continued without it);
    * ``rerouted`` — ``[(uid, from_model, to_model)]`` deterministic
      next-best reroutes;
    * ``skipped`` — ``{model: waves}`` skipped on an open breaker;
    * ``failed`` — ``{uid: reason}`` requests that exhausted every
      candidate engine (typed terminal errors, never silent drops)."""

    def __init__(self):
        super().__init__()
        self.errors: Dict[str, List[Dict]] = {}
        self.rerouted: List[Tuple[int, str, str]] = []
        self.skipped: Dict[str, int] = {}
        self.failed: Dict[int, str] = {}

    @property
    def ok(self) -> bool:
        return not self.errors and not self.failed

    def record_error(self, model: str, exc: BaseException,
                     uids: List[int]) -> None:
        self.errors.setdefault(model, []).append({
            "error": type(exc).__name__,
            "detail": str(exc),
            "uids": list(uids),
        })

    def summary(self) -> Dict:
        return {"steps": dict(self), "errors": self.errors,
                "rerouted": self.rerouted, "skipped": self.skipped,
                "failed": self.failed}


# ---------------------------------------------------------------------------
# fault injector — chaos harness around any engine
# ---------------------------------------------------------------------------


class FaultInjector:
    """Wrap a `ServingEngine` and inject faults at the wave boundary.

    Modes: ``None`` (pass through), ``"raise"`` (fail the wave with
    `InjectedFault`), ``"hang"`` (block until ``heal()`` or ``hang_s``,
    then fail — exercising the caller's execution deadline), ``"latency"``
    (sleep ``latency_s`` then serve), ``"flaky"`` (fail a seeded
    ``flaky_pct`` fraction of waves).  Attribute access delegates to the
    wrapped engine, so the injector drops into any engine dict."""

    def __init__(self, engine: ServingEngine, mode: Optional[str] = None,
                 *, latency_s: float = 0.05, flaky_pct: float = 0.5,
                 hang_s: float = 3600.0, seed: int = 0):
        self.engine = engine
        self.mode = mode
        self.latency_s = float(latency_s)
        self.flaky_pct = float(flaky_pct)
        self.hang_s = float(hang_s)
        self._release = threading.Event()
        self._rng = np.random.default_rng(seed)
        self.injected = {"raise": 0, "hang": 0, "latency": 0, "flaky": 0}
        self.waves = 0

    def set_mode(self, mode: Optional[str]) -> None:
        self.mode = mode
        if mode != "hang":
            self._release.set()       # free any wave stuck in a hang
        else:
            self._release.clear()

    def heal(self) -> None:
        self.set_mode(None)

    def run_until_drained(self, pending, max_steps: int = 10_000) -> int:
        self.waves += 1
        mode = self.mode
        if mode == "raise":
            self.injected["raise"] += 1
            raise InjectedFault(f"injected raise (wave {self.waves})")
        if mode == "hang":
            self.injected["hang"] += 1
            self._release.wait(self.hang_s)
            raise InjectedFault(f"injected hang released "
                                f"(wave {self.waves})")
        if mode == "latency":
            self.injected["latency"] += 1
            time.sleep(self.latency_s)
        elif mode == "flaky" and self._rng.random() < self.flaky_pct:
            self.injected["flaky"] += 1
            raise InjectedFault(f"injected flaky failure "
                                f"(wave {self.waves})")
        return self.engine.run_until_drained(pending, max_steps)

    def __getattr__(self, name):
        return getattr(self.engine, name)
