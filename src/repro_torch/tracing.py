"""Spans and counters inside the port's hot paths, on the device trace's
clock.

The route wave (`MicroBatcher.flush` -> `RouterService.submit_texts` ->
the encoder and `KNNRouter.serve_fused`) and the training step
(`training.train_step`) open a span at each layer boundary::

    with tracing.span("encoder.tokenize"):
        ...
    tracing.count(tracing.HOST_SYNCS)

Tracing is off by default and turns on through `enable()` or while a
``torch.profiler`` session records (its active steps, not its warm-up).
Off, `span` costs one flag check and hands back a shared null context,
and `count` returns at once; nothing is recorded.

On, each span records its name, start and end, the span it nests in (on
its own thread), the id of the outermost span open around it (one id a
wave or a step: every span of a wave carries its wave's) and its
attributes, into a ring of `CAPACITY` records (the oldest dropped), and
adds to running totals by name.  Under a profiler each span is also a
``record_function("repro.<name>")`` annotation in the trace.  Timestamps
are ``time.time_ns()``: the clock the profiler puts its host events on
(epoch nanoseconds), so a record and its annotation agree to the
annotation's own cost, a few microseconds, and a record can be laid
beside the device's operations in the trace.  A counter adds to a total
by name and by the span innermost at the call (its site; see `count`).

Readers: `records()` (the ring, oldest first), `summary()` (count and
total ms by span name, the counters and their sites: the gateway's
``/stats``), and the benchmark's per-layer metrics.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

#: records the ring keeps (a backlog wave makes about a dozen, a training
#: step five)
CAPACITY = 1 << 16
#: the prefix of a span's annotation in a profiler trace
PREFIX = "repro."
#: the counter of host calls that wait for the card: every one of the
#: route path's (held to `analysis.sanitizers.SyncCounter` on the card),
#: and RoPE's copy of its frequencies wherever it runs
HOST_SYNCS = "host_syncs"


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    root: int
    attrs: dict


_enabled = False
_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_totals: Dict[str, List[int]] = {}          # name -> [count, ns]
_counters: Dict[str, Dict[str, int]] = {}   # name -> {site: n}
_roots = itertools.count(1)
_local = threading.local()
_open: list = []        # open spans of every thread, in the order opened
_NULL = contextlib.nullcontext()


def enable() -> None:
    """Record spans and counters from now on, with or without a
    profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record only while a profiler records (the default)."""
    global _enabled
    _enabled = False


def active() -> bool:
    return _enabled or _profiler._is_profiler_enabled


def reset() -> None:
    """Forget every record, total and counter."""
    with _lock:
        _ring.clear()
        _totals.clear()
        _counters.clear()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "attrs", "parent", "root", "start", "annotation")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        st = _stack()
        if st:
            self.parent, self.root = st[-1].name, st[-1].root
        else:
            self.parent, self.root = None, next(_roots)
        st.append(self)
        _open.append(self)
        self.annotation = None
        if _profiler._is_profiler_enabled:
            self.annotation = _profiler.record_function(PREFIX + self.name)
            self.annotation.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        # both ends stamped after the annotation's call: the profiler
        # stamps early inside its enter and late inside its exit
        end = time.time_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        _open.remove(self)
        rec = Record(self.name, self.start, end, self.parent, self.root,
                     self.attrs)
        with _lock:
            _ring.append(rec)
            tot = _totals.setdefault(self.name, [0, 0])
            tot[0] += 1
            tot[1] += end - self.start


def span(name: str, **attrs):
    """A context manager around one layer's work of a wave or a step."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, attrs)


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` at the innermost span open on this
    thread, or on a thread that opened none (autograd's, running a
    backward) at the latest span opened on any thread.  ``n`` may be a
    device tensor: it is added on the device, where it stays until
    `summary` reads it, so a count never waits for the card."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    st = _stack()
    try:
        site = (st or _open)[-1].name
    except IndexError:          # no span open anywhere
        site = ""
    with _lock:
        sites = _counters.setdefault(name, {})
        sites[site] = sites.get(site, 0) + n


def _value(n):
    """A counter's number: a device tensor read back (one wait, here)."""
    return n.item() if hasattr(n, "item") else n


def records() -> List[Record]:
    """The ring's records, oldest first."""
    with _lock:
        return list(_ring)


def summary() -> dict:
    """Count and total ms by span name, and each counter's total and its
    sites, since the last `reset`; JSON-ready."""
    with _lock:
        spans = {k: {"count": c, "total_ms": ns / 1e6}
                 for k, (c, ns) in sorted(_totals.items())}
        counters = {k: {s: _value(n) for s, n in v.items()}
                    for k, v in _counters.items()}
    ctr = {k: {"total": sum(v.values()), "sites": dict(sorted(v.items()))}
           for k, v in sorted(counters.items())}
    return {"active": active(), "spans": spans, "counters": ctr}
