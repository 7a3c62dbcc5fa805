"""Fault-tolerance pieces the routing service's `execute` needs (mirrors
`repro.serving.faults`): per-engine circuit breakers (`EngineHealth`), the
typed `CircuitOpenError` / `EngineDeadlineExceeded`, and the
`ExecutionReport` that `execute` returns.  The degradation ladder, the
overload error and the fault injector are not ported yet."""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# execution report
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

    def record_error(self, model: str, exc: BaseException,
                     uids: List[int]) -> None:
        self.errors.setdefault(model, []).append({
            "error": type(exc).__name__,
            "detail": str(exc),
            "uids": list(uids),
        })
