"""Spans and the device trace of a traced run.

`Spans` records host-clock spans around the benchmark's calls into each
layer of the port (always, at the cost of two clock reads), and, when the
run is traced, marks them in the profiler's trace as user annotations
named ``bench.<span>``.

`Tracer` is the profiler window, widened from ``chip_smoke.py``'s
``device_profile`` / ``_profile_window`` (frozen here, since the program
may change): the profiler is started and warmed on one call of the cell's
own work before the window (a cold window loses its first kernels), then
traces the whole measured window.  From the trace it reads

- ``busy_s``: the union of the device's operation intervals (kernels,
  copies, fills) inside the window, so that overlapping streams are not
  counted twice;
- ``window_s``: the window's length on the trace's clock;
- ``kernels``: device seconds and launches by kernel name;
- ``idle_gaps``: the window's idle device time, by what the host was
  doing: each idle interval cut at the benchmark spans' edges, each piece
  named by the innermost span open over it ("between calls" where none
  was).
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

WINDOW = "bench.window"


class Spans:
    """Host-clock durations by span name, and their marks in a trace."""

    def __init__(self):
        self.ms = collections.defaultdict(list)
        self.traced = False

    @contextlib.contextmanager
    def span(self, name: str):
        if self.traced:
            from torch.profiler import record_function
            cm = record_function("bench." + name)
        else:
            cm = contextlib.nullcontext()
        t0 = time.perf_counter()
        with cm:
            yield
        self.ms[name].append((time.perf_counter() - t0) * 1e3)

    def mean_ms(self, name: str):
        v = self.ms.get(name)
        return sum(v) / len(v) if v else None


class Tracer:
    """``with tracer.window(): ...`` around the measured window; ``warm``
    runs once under the profiler first, and is discarded."""

    def __init__(self, torch, enabled: bool):
        self.torch = torch
        self.enabled = enabled
        self.result = None
        self.error = None

    @contextlib.contextmanager
    def window(self, warm=None):
        if not self.enabled:
            yield
            return
        torch = self.torch
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function, schedule)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)

        def ready(p):
            try:
                self.result = read_trace(p)
            except Exception as exc:        # the trace could not be read
                self.error = f"{type(exc).__name__}: {exc}"

        prof = profile(activities=acts,
                       schedule=schedule(wait=0, warmup=1, active=1),
                       on_trace_ready=ready)
        prof.start()
        try:
            if warm is not None:
                warm()
            _sync(torch)
            prof.step()
            with record_function(WINDOW):
                yield
                _sync(torch)
            prof.step()
        finally:
            prof.stop()
        if self.result is None and self.error is None:
            self.error = "the profiler delivered no trace"


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _kind(ev) -> str:
    """'device' for an operation on the device, 'annotation' for a span,
    else 'host'."""
    dt = str(ev.device_type())
    if ev.is_user_annotation():
        return "annotation" if not dt.endswith("CUDA") else "device_mark"
    if dt.endswith("CUDA"):
        act = str(getattr(ev, "activity_type", lambda: "")()).lower()
        if "annotation" in act:
            return "device_mark"
        return "device"
    return "host"


def read_trace(prof) -> dict:
    """busy_s, window_s, kernels and idle_gaps of the trace's window."""
    events = prof.profiler.kineto_results.events()
    win = None
    spans = []                      # (start, end, name) of bench spans
    ops = []                        # (start, end, name) on the device
    for ev in events:
        kind = _kind(ev)
        if kind == "annotation":
            name = ev.name()
            if name == WINDOW:
                win = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
            elif name.startswith("bench."):
                spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                              name[len("bench."):]))
        elif kind == "device":
            ops.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                        ev.name()))
    if win is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win
    by_name = collections.defaultdict(lambda: [0, 0])
    clipped = []
    for s, e, name in ops:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        by_name[name][0] += e - s
        by_name[name][1] += 1
    clipped.sort()
    busy = 0
    gaps = []
    cur_s = cur_e = None
    last_end = w0
    for s, e in clipped:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last_end:
        gaps.append((last_end, w1))
    spans.sort()
    idle = collections.defaultdict(int)
    for g0, g1 in gaps:
        for name, t in _split(spans, g0, g1):
            idle[name] += t
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernels": {n: (t / 1e9, c) for n, (t, c) in by_name.items()},
        "idle_gaps": sorted(((n, t / 1e9) for n, t in idle.items()),
                            key=lambda x: -x[1]),
        "n_device_ops": len(clipped),
    }


def _split(spans, g0, g1):
    """[(name, ns)]: the interval [g0, g1] cut where a benchmark span opens
    or closes, each piece named by the innermost (latest-opened) span open
    over it, "between calls" where none is."""
    # spans that overlap the gap: they start before g1 and end after g0
    hi = bisect.bisect_left(spans, (g1,))
    live = [sp for sp in spans[max(0, hi - 256):hi] if sp[1] > g0]
    cuts = sorted({g0, g1} | {t for s, e, _ in live for t in (s, e)
                              if g0 < t < g1})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        name = "between calls"
        for s, e, n in live:            # sorted by start: the last wins
            if s <= mid < e:
                name = n
        out.append((name, b - a))
    return out


def kernel_time(trace: dict, *substrings) -> tuple:
    """(device seconds, launches) of the kernels whose names hold any of
    ``substrings``."""
    t = c = 0
    for name, (s, n) in trace["kernels"].items():
        if any(x in name for x in substrings):
            t += s
            c += n
    return t, c


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time and the ten largest
    idle shares by what the host was doing, as the result line carries
    them."""
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[n[:160], s] for n, (s, _) in ops],
            "idle_gaps": [[n, s] for n, s in trace["idle_gaps"][:10]]}
