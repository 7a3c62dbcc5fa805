"""Request-level scheduling of the port (mirrors
`repro.serving.scheduler`): micro-batch coalescing in front of the router
and admission waves behind it.

`MicroBatcher` sits between request arrival and routing: concurrent small
requests accumulate (each with its own per-request lambda) and one
``flush()`` routes them all through `RouterService.route_fused`: one
retrieval and decision pass on the card for the whole wave, which
amortizes the route's fixed host and launch cost when traffic arrives as
single requests instead of ready-made batches.  ``submit`` hands back a
**stable ticket id** (not a queue position: positions go stale the moment
a flush truncates the queue at ``max_batch``), and ``pop_result(ticket)``
retrieves a routed request's result whenever its wave happened to flush.

Wave closing is policy-driven when a fitted `DispatchPolicy` is available
(`MicroBatcher.from_policy`): the policy's ``wave_target_batch`` (the knee
of the measured batch-amortization curve) becomes ``max_batch``, and its
``wave_close_timeout_s`` (the measured single-request route p50) bounds how
long a partial wave may be held open, so an idle stream waits at most
about one solo route while a loaded stream fills the wave first.

`WaveScheduler` batches admitted requests into per-engine decode waves
with FIFO order and slot backpressure.  Constructed with a ``batcher``,
every ``tick()`` first flushes pending routes (respecting the batcher's
wave-close rule) and enqueues the results, so the serving loop is arrival
-> coalesced route -> admission -> decode with no per-request route."""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from .engine import Request, ServingEngine
from .faults import DegradationLadder, Overloaded


@dataclass
class SchedulerStats:
    admitted: int = 0
    completed: int = 0
    waves: int = 0


class MicroBatcher:
    """Coalesce concurrent route requests into one fused dispatch.

    ``submit(text, lam)`` queues a request and returns a stable ticket id;
    ``flush()`` routes up to ``max_batch`` queued requests with a single
    `RouterService.submit_texts` call (one ``route_fused`` for the whole
    micro-batch, per-request lambdas preserved) and returns
    the `RoutedResult`s in submission order; anything beyond ``max_batch``
    stays queued for the next wave.  Each flushed result is also retained
    under its ticket until claimed via ``pop_result`` — tickets stay valid
    across any number of partial flushes.

    ``close_timeout_s`` (usually from `from_policy`) makes ``ready()`` /
    ``maybe_flush()`` hold a partial wave open until either ``max_batch``
    requests are pending or the oldest has waited that long; with no
    timeout configured any pending request makes the wave ready, which is
    the old always-flush behaviour.  ``clock`` is injectable for tests.

    **Admission control** — ``max_pending`` bounds the queue: a ``submit``
    past the bound raises a typed `Overloaded` carrying a retry-after hint
    (estimated backlog drain time), never a silent drop; the queue recovers
    as flushes drain it.  **Graceful degradation** — with a ``ladder``
    configured, each flush picks a retrieval degradation level from queue
    depth and deadline headroom (``deadline_s`` = per-request service-level
    deadline measured from submit) and serves the wave at that level; every
    result is annotated with it (`RoutedResult.degradation`).  With no
    ladder the wave is always served at full fidelity."""

    def __init__(self, service, max_batch: int = 64,
                 max_new_tokens: int = 8,
                 close_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_pending: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 ladder: Optional[DegradationLadder] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.service = service
        self.max_batch = int(max_batch)
        self.max_new_tokens = int(max_new_tokens)
        self.close_timeout_s = (None if close_timeout_s is None
                                else float(close_timeout_s))
        self.clock = clock
        self.max_pending = None if max_pending is None else int(max_pending)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.ladder = ladder
        # (ticket, text, lam, t_submit); tickets are monotonic and never
        # reused, so they survive partial flushes truncating the queue
        self._queue: Deque[Tuple[int, str, Optional[float], float]] = \
            collections.deque()
        self._results: Dict[int, object] = {}
        self._next_ticket = 0
        self._closed = False
        self.flushes = 0          # dispatches actually issued
        self.routed = 0           # requests routed through them
        self.shed = 0             # submissions rejected at the bound
        self.degraded_waves = 0   # flushes served above ladder level 0
        self.last_degradation = 0

    @classmethod
    def from_policy(cls, service, max_new_tokens: int = 8,
                    clock: Callable[[], float] = time.monotonic,
                    **overrides) -> "MicroBatcher":
        """Build a batcher whose wave-close constants come from the
        service's fitted `DispatchPolicy` (measured batch-amortization
        knee + solo-dispatch p50).  Falls back to the static defaults when
        no policy is fitted or the policy carries no wave constants.
        ``overrides`` (e.g. ``max_pending``, ``deadline_s``, ``ladder``)
        pass through to the constructor and win over the policy."""
        pol = getattr(service, "dispatch_policy", None)
        kw = {}
        if pol is not None:
            if getattr(pol, "wave_target_batch", 0):
                kw["max_batch"] = int(pol.wave_target_batch)
            if getattr(pol, "wave_close_timeout_s", 0.0):
                kw["close_timeout_s"] = float(pol.wave_close_timeout_s)
        kw.update(overrides)
        return cls(service, max_new_tokens=max_new_tokens, clock=clock, **kw)

    def pending(self) -> int:
        return len(self._queue)

    def retry_after_s(self) -> float:
        """Estimated time for the backlog to drain one wave — the hint a
        shed submission carries so clients back off instead of hammering."""
        per_wave = self.close_timeout_s if self.close_timeout_s else 0.01
        waves = max(len(self._queue) / max(self.max_batch, 1), 1.0)
        return per_wave * waves

    def submit(self, text: str, lam: Optional[float] = None) -> int:
        """Queue a request; returns its ticket (stable across flushes —
        claim the result later with ``pop_result(ticket)``).  Past the
        ``max_pending`` bound this sheds explicitly: a typed `Overloaded`
        with a retry-after hint, never a silent drop."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed; no new submissions")
        if (self.max_pending is not None
                and len(self._queue) >= self.max_pending):
            self.shed += 1
            raise Overloaded(
                f"queue full ({len(self._queue)}/{self.max_pending} "
                f"pending); retry after ~{self.retry_after_s():.3f}s",
                retry_after_s=self.retry_after_s(),
                pending=len(self._queue))
        ticket = self._next_ticket
        self._next_ticket += 1
        self._queue.append((ticket, text, lam, self.clock()))
        return ticket

    def ready(self) -> bool:
        """Whether the pending wave should close now: always when no
        timeout is configured, else when it is full (``max_batch``) or its
        oldest request has waited ``close_timeout_s``."""
        if not self._queue:
            return False
        if self.close_timeout_s is None:
            return True
        if len(self._queue) >= self.max_batch:
            return True
        return self.clock() - self._queue[0][3] >= self.close_timeout_s

    def maybe_flush(self) -> List:
        """``flush()`` if the wave-close rule says the wave is ready,
        else keep accumulating and return []."""
        return self.flush() if self.ready() else []

    def _degradation_level(self) -> int:
        """Ladder level for the wave about to flush, from queue depth and
        the oldest request's deadline headroom.  0 (full fidelity) when no
        ladder is configured — the default path is untouched."""
        if self.ladder is None or not self._queue:
            return 0
        headroom = 1.0
        if self.deadline_s:
            waited = self.clock() - self._queue[0][3]
            headroom = 1.0 - waited / self.deadline_s
        return self.ladder.level_for(len(self._queue), self.max_batch,
                                     headroom=headroom)

    def flush(self) -> List:
        """Route the pending wave (up to ``max_batch``) in ONE route,
        served at the deadline-driven degradation level (annotated on every
        result)."""
        if not self._queue:
            return []
        level = self._degradation_level()
        wave = [self._queue.popleft()
                for _ in range(min(self.max_batch, len(self._queue)))]
        tickets = [w[0] for w in wave]
        texts = [w[1] for w in wave]
        default = self.service.default_lam
        lam_vec = np.asarray([default if w[2] is None else float(w[2])
                              for w in wave], np.float32)
        # only pass degrade= when the ladder engaged: level 0 keeps the
        # call valid for any service whose submit_texts lacks the argument
        kw = {"degrade": level} if level else {}
        results = self.service.submit_texts(
            texts, max_new_tokens=self.max_new_tokens, lam=lam_vec, **kw)
        for t, res in zip(tickets, results):
            self._results[t] = res
        self.flushes += 1
        self.routed += len(results)
        self.last_degradation = level
        if level:
            self.degraded_waves += 1
        return results

    def pop_result(self, ticket: int):
        """Claim (and forget) the `RoutedResult` of a flushed ticket, or
        None while its wave is still pending."""
        return self._results.pop(ticket, None)

    def cancel(self, ticket: int) -> bool:
        """Withdraw a ticket: a still-queued submission leaves the queue
        (freeing its ``max_pending`` admission slot immediately — a client
        that hung up must not hold capacity), and an already-routed,
        unclaimed result is forgotten.  Returns True when the ticket was
        still queued (its text will never be routed); False once its wave
        has flushed — the caller then owns cancelling the in-flight
        `Request` (``request.cancelled``) instead."""
        for i, entry in enumerate(self._queue):
            if entry[0] == ticket:
                del self._queue[i]
                return True
        self._results.pop(ticket, None)
        return False

    def close(self) -> None:
        """Drain: flush every still-pending wave so ALL outstanding tickets
        resolve, then refuse new submissions.  Idempotent.  Unclaimed
        results stay claimable through ``pop_result`` after close — a
        ticket holder must never lose its answer to a shutdown race."""
        if self._closed:
            return
        while self._queue:
            self.flush()
        self._closed = True


class WaveScheduler:
    def __init__(self, engines: Dict[str, ServingEngine],
                 batcher: Optional[MicroBatcher] = None):
        self.engines = engines
        self.batcher = batcher
        self.queues: Dict[str, Deque[Request]] = {
            m: collections.deque() for m in engines}
        self.stats = SchedulerStats()

    def enqueue(self, model: str, req: Request):
        self.queues[model].append(req)

    def submit_text(self, text: str, lam: Optional[float] = None):
        """Queue a text through the micro-batcher (requires ``batcher``);
        it is routed — coalesced with its wave — on the next ``tick()``."""
        if self.batcher is None:
            raise RuntimeError("WaveScheduler was built without a "
                               "MicroBatcher; pass batcher= to coalesce "
                               "text requests")
        self.batcher.submit(text, lam)

    def pending(self) -> int:
        n = sum(len(q) for q in self.queues.values())
        if self.batcher is not None:
            n += self.batcher.pending()
        return n

    def tick(self):
        """One scheduling wave: flush the micro-batcher when its wave-close
        rule fires (one ``route_fused`` for every request the wave
        coalesced), then admit up to free slots per engine and run one
        decode step each."""
        if self.batcher is not None:
            for res in self.batcher.maybe_flush():
                self.enqueue(res.model, res.request)
        for m, eng in self.engines.items():
            q = self.queues[m]
            while q and eng.has_free_slot():
                eng.admit(q.popleft())
                self.stats.admitted += 1
            before = sum(r is not None for r in eng.slot_req)
            eng.step()
            after = sum(r is not None for r in eng.slot_req)
            self.stats.completed += before - after
        self.stats.waves += 1

    def drain(self, max_waves: int = 50_000):
        while (self.pending() or any(
                any(r is not None for r in e.slot_req)
                for e in self.engines.values())) and self.stats.waves < max_waves:
            self.tick()
        return self.stats
