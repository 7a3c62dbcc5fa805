"""The port's spans in a trace (`bench.program_trace`) over synthetic
profiler events: `read_trace`'s keys stay as they were beside ``repro.``
annotations; device time goes to the span that holds its launch, matched
by correlation id across threads; idle time goes to the innermost program
span, however many spans the enclosing one holds; and the per-layer
readers of the port's records return None where there are none, and a
number from a small traced run of the backlog cell on the CPU."""
import sys
from types import SimpleNamespace

import pytest

from bench import common, profiling
from bench import program_trace as PT
from bench.tests.conftest import run_small

NEW = ("tokenize_ms.backlog", "results_ms.backlog", "host_syncs.backlog")


class Ev:
    """What `profiling._kind` and the readers ask of a kineto event."""

    def __init__(self, name, s, e, kind, corr=0):
        self._n, self._s, self._d, self._k, self._c = name, s, e - s, \
            kind, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._k in ("mark", "device_mark")

    def device_type(self):
        return "DeviceType.CUDA" if self._k in ("device", "device_mark") \
            else "DeviceType.CPU"


def mark(name, s, e):
    return Ev(name, s, e, "mark")


def op(name, s, e, corr):
    return Ev(name, s, e, "device", corr)


def launch(s, corr, name="cudaLaunchKernel"):
    return Ev(name, s, s + 5, "host", corr)


def prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def _route_events():
    """A window of two waves: benchmark spans, device work and its
    launches, without the program's annotations."""
    evs = [mark(profiling.WINDOW, 0, 10_000)]
    corr = 1
    for w0 in (1_000, 6_000):
        evs += [mark("bench.wave", w0, w0 + 3_000),
                mark("bench.encoder", w0 + 100, w0 + 1_000),
                mark("bench.router", w0 + 1_200, w0 + 2_000)]
        for t in (w0 + 500, w0 + 1_400):
            evs += [launch(t, corr), op("kernel", t + 10, t + 300, corr)]
            corr += 1
    return evs


def _program_marks():
    """The port's annotations of the same two waves, and their marks on
    the device's row, which the readers leave aside."""
    evs = []
    for w0 in (1_000, 6_000):
        evs += [mark("repro.scheduler.flush", w0 + 10, w0 + 2_900),
                mark("repro.encoder.embed", w0 + 100, w0 + 1_000),
                mark("repro.encoder.tokenize", w0 + 110, w0 + 480),
                mark("repro.encoder.forward", w0 + 490, w0 + 520),
                mark("repro.router.serve", w0 + 1_200, w0 + 2_000),
                mark("repro.service.results", w0 + 2_100, w0 + 2_800),
                Ev("repro.encoder.forward", w0 + 500, w0 + 800,
                   "device_mark")]
    return evs


def test_read_trace_keys_unchanged_beside_program_marks():
    base = _route_events()
    assert profiling.read_trace(prof(base)) == \
        profiling.read_trace(prof(base + _program_marks()))


def test_device_time_follows_the_launch_across_threads():
    """The backward's kernel is launched from autograd's thread while the
    main thread is inside ``train.backward``, and runs after the span has
    closed; a copy launched inside ``train.optimizer``; a kernel whose
    launch the trace lacks; one launched outside every span."""
    evs = [mark(profiling.WINDOW, 0, 1_000),
           mark("repro.train.step", 10, 600),
           mark("repro.train.forward", 20, 100),
           mark("repro.train.backward", 100, 300),
           mark("repro.train.optimizer", 300, 500),
           launch(30, 1), op("fwd", 40, 90, 1),
           launch(150, 2), op("bwd", 310, 400, 2),      # other thread
           launch(320, 3, "cudaMemcpyAsync"),
           op("Memcpy HtoD (Pageable -> Device)", 400, 420, 3),
           op("orphan", 420, 430, 99),
           launch(700, 4), op("late", 700, 710, 4)]
    got = PT.read_program(evs)
    assert got["device_s"] == pytest.approx({
        "train.forward": 50e-9, "train.backward": 90e-9,
        "train.optimizer": 20e-9, PT.NO_LAUNCH: 10e-9, PT.OUTSIDE: 10e-9})
    assert "train.optimizer" not in got["kernel_s"]
    assert got["kernel_s"]["train.backward"] == pytest.approx(90e-9)
    assert got["leaves"] == ["train.backward", "train.forward",
                             "train.optimizer"]
    assert got["spans"]["train.step"] == 1


def test_idle_goes_to_the_innermost_program_span():
    evs = _route_events() + _program_marks()
    got = PT.read_program(evs)
    idle = got["idle_s"]
    # every idle ns of the window is named once
    tr = profiling.read_trace(prof(evs))
    assert sum(idle.values()) == pytest.approx(
        tr["window_s"] - tr["busy_s"])
    assert idle["encoder.tokenize"] == pytest.approx(2 * 370e-9)
    assert idle["service.results"] == pytest.approx(2 * 700e-9)
    by = got["idle_by_bench"]
    assert set(by["wave"]) >= {"service.results", "scheduler.flush"}
    assert by["encoder"]["encoder.tokenize"] == pytest.approx(2 * 370e-9)
    assert sum(sum(m.values()) for m in by.values()) == pytest.approx(
        sum(idle.values()))


@pytest.mark.parametrize("children", [12, 300])
def test_the_enclosing_span_is_found_past_many_children(children):
    """A wave of ``children`` nested spans (the route wave has about a
    dozen) and an idle gap after the last of them, inside the root: the
    gap is the root's, also where the root opened more than 256 spans
    before it."""
    evs = [mark(profiling.WINDOW, 0, 100_000),
           mark("repro.scheduler.flush", 10, 90_000)]
    t = 100
    for i in range(children):
        evs.append(mark(f"repro.child{i % 7}", t, t + 50))
        evs.append(mark("repro.leaf", t + 10, t + 20))
        evs += [launch(t + 12, i + 1), op("k", t + 12, t + 40, i + 1)]
        t += 100
    evs += [launch(t + 10, 10_000), op("k", t + 5_000, t + 6_000, 10_000)]
    got = PT.read_program(evs)
    gap = (t + 5_000) - (t - 100 + 50)
    assert got["idle_s"]["scheduler.flush"] >= gap * 1e-9
    parts = PT.pieces([(s, e, n) for s, e, n in got["annotations"]])
    assert parts[-1][2] == "scheduler.flush"
    assert "leaf" in got["leaves"] and "scheduler.flush" not in got["leaves"]
    summary = PT.summarize(got, 1e-6, 1)
    assert summary["roots"] == 1 and summary["kernel_share"]


def test_readers_return_none_without_records(monkeypatch):
    from repro_torch import tracing
    tracing.disable()
    tracing.reset()
    for name in NEW:
        assert common.metric_reader(name).read({}) is None
    # a checkout whose program has no tracing module
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    for name in NEW:
        assert common.metric_reader(name).read({}) is None


def test_a_traced_run_reads_every_new_metric():
    """The backlog cell at its small size on the CPU, traced: the port
    records its spans while the profiler records, and the three readers
    read them."""
    from repro_torch import tracing
    tracing.reset()
    code, res = run_small("route.knn100-1m.backlog", 123, seconds=1.0,
                          trace=1)
    assert code == 0 and res["correct"]
    m = res["metrics"]
    for name in NEW:
        assert m[name]["value"] > 0, name
    assert m["host_syncs.backlog"]["value"] == 13
    assert not tracing.active()
    tracing.reset()
