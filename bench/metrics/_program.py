"""Readers of the port's own spans and counters (`repro_torch.tracing`).

While the profiler of a traced run records (the measured window; its
warm-up step records nothing) the port keeps a record of each of its
spans in memory and counts its counters, so the records are the window's.
A wave is one ``scheduler.flush`` span.  Each reader returns None where
the checkout's program has no tracing module, or recorded nothing of
what it reads."""
from __future__ import annotations

WAVE = "scheduler.flush"


def _tracing():
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def span_ms_a_wave(name: str):
    """Mean ms a wave of the spans named ``name``."""
    tr = _tracing()
    if tr is None:
        return None
    recs = tr.records()
    waves = sum(r.name == WAVE for r in recs)
    ns = [r.end_ns - r.start_ns for r in recs if r.name == name]
    if not waves or not ns:
        return None
    return sum(ns) / 1e6 / waves


def count_a_wave(counter: str):
    """Counter ``counter``'s count over the window's waves."""
    tr = _tracing()
    if tr is None:
        return None
    waves = sum(r.name == WAVE for r in tr.records())
    ctr = tr.summary()["counters"].get(counter)
    if not waves or ctr is None:
        return None
    return ctr["total"] / waves
