#!/usr/bin/env python3
"""The port's own spans in a traced run: device and idle time by program
span, read from the profiler trace that `profiling.read_trace` reads.

While a profiler records, the port (`repro_torch.tracing`) marks each span
of a route wave and of a training step in the trace as a ``repro.<name>``
annotation, and keeps a record of it in memory on the trace's clock.
From the trace's events `read_program` gives, over the window:

- ``device_s``: each device operation's seconds (clipped to the window,
  as ``read_trace`` clips them), by the innermost program span whose
  interval holds the operation's host launch: the runtime call with the
  operation's correlation id, on whatever thread made it (autograd
  launches the backward's kernels from a thread of its own while the main
  thread sits inside ``train.backward``); ``kernel_s`` the same without
  copies and fills;
- ``idle_s``: the window's idle device time cut at the program spans'
  edges, each piece named by the innermost program span open over it;
- ``idle_by_bench``: the same idle time under each name ``read_trace``
  gives it (the benchmark's own spans), split by program span;
- ``leaves``: the program spans that hold no other program span;
- ``spans``: how many of each program span start in the window.

Where no span is open, the name is ``OUTSIDE``; a device operation whose
launch the trace lacks goes under ``NO_LAUNCH``.  The innermost span is
found by a sweep over every edge, so an enclosing span is found however
many spans it holds.

`read_trace` does not call this (it lives in `profiling.py`, which a
change of the benchmark's own files would extend).  Run as a script, it
runs one cell as `bench/run.py` does and adds what it reads, with
`summarize`'s shares and the port's counters, to the result line under
``program``::

    python3 bench/program_trace.py --workload train.danube-1.8b.s1k \\
        --seed 7 --seconds 20

``--enable 1`` instead runs the cell untraced (``--trace 0``) with the
port's tracing switched on by `repro_torch.tracing.enable`, to measure
what recording costs without a profiler.  The benchmark's own runs never
run this.
"""
from __future__ import annotations

import bisect
import collections
import heapq
import json
import statistics
import sys
from pathlib import Path

PREFIX = "repro."
OUTSIDE = "outside spans"
NO_LAUNCH = "no launch"
#: the benchmark's name for idle time under none of its spans
BETWEEN = "between calls"
#: device operations that are copies or fills, not kernels
COPIES = ("Memcpy", "Memset")


def _events(events) -> dict:
    """The trace's window, the benchmark's and the program's spans, the
    host launches by correlation id and the device operations."""
    from bench.profiling import WINDOW, _kind
    win, bench, prog, launch, ops = None, [], [], {}, []
    for ev in events:
        kind = _kind(ev)
        s, name = ev.start_ns(), ev.name()
        e = s + ev.duration_ns()
        if kind == "annotation":
            if name == WINDOW:
                win = (s, e)
            elif name.startswith("bench."):
                bench.append((s, e, name[len("bench."):]))
            elif name.startswith(PREFIX):
                prog.append((s, e, name[len(PREFIX):]))
        elif kind == "device":
            ops.append((s, e, name, ev.correlation_id()))
        elif kind == "host" and name.startswith("cu"):
            # a CUDA runtime or driver call (a launch, a copy, a fill):
            # the device operation of its correlation id was made here
            launch.setdefault(ev.correlation_id(), s)
    if win is None:
        raise RuntimeError("the trace holds no window span")
    return {"window": win, "bench": bench, "program": prog,
            "launch": launch, "ops": ops}


def pieces(spans) -> list:
    """[(a, b, name)]: the union of ``spans`` ((start, end, name)) cut at
    every span's edges, each piece named by the innermost span open over
    it: the latest opened, the shorter of two opened together."""
    edges = sorted({t for s, e, _ in spans for t in (s, e)})
    opens = sorted(spans)
    heap, out, i = [], [], 0
    for a, b in zip(edges, edges[1:]):
        while i < len(opens) and opens[i][0] <= a:
            s, e, n = opens[i]
            heapq.heappush(heap, (-s, e, n))
            i += 1
        # the top is the latest opened; drop it while it has ended (an
        # ended span below it surfaces, and is dropped, in its turn)
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        if not heap:
            continue                    # no span is open over [a, b)
        n = heap[0][2]
        if out and out[-1][1] == a and out[-1][2] == n:
            out[-1] = (out[-1][0], b, n)
        else:
            out.append((a, b, n))
    return out


def cut(intervals, parts, default) -> list:
    """[(i, a, b, name)]: interval ``i`` of ``intervals`` ((a, b), sorted)
    cut by the pieces ``parts`` of `pieces`, each piece of it named as the
    part over it, ``default`` where none is."""
    starts = [p[0] for p in parts]
    out = []
    for i, (g0, g1) in enumerate(intervals):
        t = g0
        j = max(0, bisect.bisect_right(starts, g0) - 1)
        while t < g1:
            while j < len(parts) and parts[j][1] <= t:
                j += 1
            if j == len(parts) or parts[j][0] >= g1:
                out.append((i, t, g1, default))
                break
            a, b, n = parts[j]
            if a > t:
                out.append((i, t, a, default))
                t = a
            out.append((i, t, min(b, g1), n))
            t = min(b, g1)
    return out


def _gaps(ops, w0, w1):
    """The window's idle intervals: outside the union of ``ops``."""
    gaps, last = [], w0
    for s, e in sorted(ops):
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((last, w1))
    return gaps


def _leaves(spans) -> list:
    """Names of the spans that never hold another span."""
    parents, stack = set(), []
    for s, e, n in sorted(spans, key=lambda sp: (sp[0], -sp[1])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack and e <= stack[-1][1]:
            parents.add(stack[-1][2])
        stack.append((s, e, n))
    return sorted({n for _, _, n in spans} - parents)


def read_program(events) -> dict:
    """Device and idle seconds of the trace's window by program span (see
    the module's docstring)."""
    ev = _events(events)
    w0, w1 = ev["window"]
    prog = pieces(ev["program"])
    starts = [p[0] for p in prog]
    device = collections.defaultdict(float)
    kernel = collections.defaultdict(float)
    clipped = []
    for s, e, name, corr in ev["ops"]:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        t = ev["launch"].get(corr)
        if t is None:
            n = NO_LAUNCH
        else:
            j = bisect.bisect_right(starts, t) - 1
            n = prog[j][2] if j >= 0 and t < prog[j][1] else OUTSIDE
        device[n] += (e - s) / 1e9
        if not name.startswith(COPIES):
            kernel[n] += (e - s) / 1e9
    gaps = _gaps(clipped, w0, w1)
    idle = collections.defaultdict(float)
    for _, a, b, n in cut(gaps, prog, OUTSIDE):
        idle[n] += (b - a) / 1e9
    by_bench = collections.defaultdict(lambda: collections.defaultdict(float))
    sub = cut(gaps, pieces(ev["bench"]), BETWEEN)
    for i, a, b, n in cut([(a, b) for _, a, b, _ in sub], prog, OUTSIDE):
        by_bench[sub[i][3]][n] += (b - a) / 1e9
    inside = [sp for sp in ev["program"] if w0 <= sp[0] < w1]
    return {"device_s": dict(device), "kernel_s": dict(kernel),
            "idle_s": dict(idle),
            "idle_by_bench": {k: dict(v) for k, v in by_bench.items()},
            "leaves": _leaves(inside),
            "spans": dict(collections.Counter(n for _, _, n in inside)),
            "window": [w0, w1], "annotations": sorted(inside)}


def clock_gaps_us(records, annotations) -> list:
    """|start| and |end| gaps, in us, between each in-memory record of
    `repro_torch.tracing` and its annotation in the trace, matched by name
    and order."""
    mine = collections.defaultdict(list)
    for r in records:
        mine[r.name].append((r.start_ns, r.end_ns))
    theirs = collections.defaultdict(list)
    for s, e, n in annotations:
        theirs[n].append((s, e))
    gaps = []
    for n, spans in mine.items():
        for (s0, e0), (s1, e1) in zip(sorted(spans), sorted(theirs[n])):
            gaps += [abs(s0 - s1) / 1e3, abs(e0 - e1) / 1e3]
    return gaps


def summarize(prog: dict, busy_s: float, roots: int, records=None) -> dict:
    """Per wave or step (``roots`` of them in the window): device and idle
    ms by span; the kernels' time's shares by span; the
    benchmark's idle names split into leaf and parent spans; with the
    port's ``records``, the clock gaps to their annotations."""
    per = max(roots, 1)
    dev, idle, ker = prog["device_s"], prog["idle_s"], prog["kernel_s"]
    total = sum(ker.values())
    out = {"roots": roots,
           "device_ms": {k: 1e3 * v / per for k, v in sorted(dev.items())},
           "idle_ms": {k: 1e3 * v / per for k, v in sorted(idle.items())},
           "busy_ms": 1e3 * busy_s / per,
           "kernel_share": {k: v / total for k, v in sorted(ker.items())}
           if total else {},
           "leaves": prog["leaves"], "spans": prog["spans"]}
    leaves = set(prog["leaves"])
    out["idle_by_bench_ms"] = {
        b: {k: 1e3 * v / per for k, v in sorted(m.items())}
        for b, m in prog["idle_by_bench"].items()}
    out["idle_leaf_share"] = {
        b: sum(v for k, v in m.items() if k in leaves) / sum(m.values())
        for b, m in prog["idle_by_bench"].items() if sum(m.values())}
    if records is not None:
        gaps = clock_gaps_us(records, prog["annotations"])
        if gaps:
            q = statistics.quantiles(gaps, n=20) if len(gaps) > 1 else gaps
            out["clock_gap_us"] = {"median": statistics.median(gaps),
                                   "p95": q[-1], "max": max(gaps),
                                   "n": len(gaps)}
    return out


def main(argv=None) -> int:
    import argparse
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    from bench import profiling, run
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--enable", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    run._environment()
    from repro_torch import tracing
    held = {}
    base = profiling.read_trace

    def read_trace(prof):
        out = base(prof)
        held["program"] = read_program(prof.profiler.kineto_results.events())
        return out

    profiling.read_trace = read_trace
    if a.enable:
        tracing.enable()
    args = run.parse(["--workload", a.workload, "--seed", str(a.seed),
                      "--seconds", str(a.seconds), "--trace",
                      str(1 - a.enable)])
    code, result = run.run_cell(args)
    if result is not None and "program" in held:
        prog = held["program"]
        roots = sum(c for n, c in prog["spans"].items()
                    if n in ("scheduler.flush", "train.step"))
        result["program"] = summarize(prog, result["device"]["busy_s"],
                                      roots, tracing.records())
        result["program"]["counters"] = tracing.summary()["counters"]
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
