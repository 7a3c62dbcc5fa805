"""`repro_torch.tracing` on the CPU: off by default (no record, no
annotation), on through `enable()` or a recording profiler; the route
wave's and the training step's spans nest as the hot paths call them and
carry their wave's or step's id; the ring keeps its capacity; a record
and its ``repro.`` annotation in a CPU profiler's trace agree within
50 us; and results and training updates are bitwise equal with tracing on
and off.  One ``gpu`` test ties ``host_syncs`` to `SyncCounter` over a
backlog-sized wave on the card."""
import collections
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.dataset import RoutingDataset  # noqa: E402
from repro_torch.core.routers import make_router  # noqa: E402
from repro_torch.data.lm_data import DataConfig, SyntheticLMStream  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.encoder import QueryEncoder  # noqa: E402
from repro_torch.serving.router_service import RouterService  # noqa: E402
from repro_torch.serving.scheduler import MicroBatcher  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

POOL = ("model-a", "model-b", "model-c")
#: (span, the span it nests in) of one route wave
WAVE = {("scheduler.flush", None), ("service.submit", "scheduler.flush"),
        ("encoder.embed", "service.submit"),
        ("encoder.tokenize", "encoder.embed"),
        ("encoder.forward", "encoder.embed"),
        ("encoder.d2h", "encoder.embed"),
        ("service.route", "service.submit"),
        ("router.serve", "service.route"),
        ("router.search", "router.serve"), ("router.tail", "router.serve"),
        ("router.d2h", "router.serve"),
        ("service.results", "service.submit")}
#: ... and of one training step
STEP = {("train.step", None), ("train.forward", "train.step"),
        ("train.backward", "train.step"), ("train.optimizer", "train.step"),
        ("train.clip", "train.optimizer")}
#: a wave's host syncs by site in steady state: the encoder's tokens in
#: and its two layers' RoPE frequencies for q and k, its output out, the
#: lambdas' and the queries' copies in, the five outputs out
WAVE_SYNCS = {"encoder.forward": 5, "encoder.d2h": 1, "router.serve": 1,
              "router.search": 1, "router.d2h": 5}


@pytest.fixture
def clean():
    """Tracing off and empty around the test."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _service(device="cpu", n=2000, k=10):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(n, 768)).astype(np.float32)
    S = rng.uniform(0.2, 1.0, (n, len(POOL))).astype(np.float32)
    C = rng.uniform(1e-3, 1e-2, (n, len(POOL))).astype(np.float32)
    ds = RoutingDataset("tracing", X, S, C, list(POOL))
    engines = {m: SimpleNamespace(cfg=SimpleNamespace(vocab_size=1000))
               for m in POOL}
    return RouterService(make_router(f"knn{k}", device=device), engines,
                         ds=ds, encoder=QueryEncoder(device=device))


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    words = ["algebra", "proof", "poem", "history", "python", "cells",
             "router", "wave", "kernel", "budget"]
    return [" ".join(rng.choice(words, rng.integers(1, 12)))
            for _ in range(n)]


def _wave(batcher, texts, lams):
    tickets = [batcher.submit(t, float(lam)) for t, lam in zip(texts, lams)]
    batcher.flush()
    return [batcher.pop_result(tk) for tk in tickets]


@pytest.fixture(scope="module")
def svc():
    return _service()


def test_off_records_nothing_and_makes_no_annotation(clean, svc,
                                                     monkeypatch):
    calls = []
    monkeypatch.setattr(tracing._profiler, "record_function",
                        lambda *a: calls.append(a))
    assert not tracing.active()
    assert tracing.span("x") is tracing.span("y")
    with tracing.span("outer", q=3):
        tracing.count(tracing.HOST_SYNCS)
    _wave(MicroBatcher(svc, max_batch=8), _texts(5), np.zeros(5))
    assert tracing.records() == [] and calls == []
    s = tracing.summary()
    assert s["active"] is False and s["spans"] == {} and s["counters"] == {}


def test_wave_spans_nest_and_carry_the_wave_id(clean, svc):
    batcher = MicroBatcher(svc, max_batch=16)
    _wave(batcher, _texts(16), np.ones(16))     # fills the device caches
    tracing.enable()
    for seed in (1, 2):
        _wave(batcher, _texts(16, seed), np.full(16, 0.5))
    recs = tracing.records()
    waves = collections.defaultdict(list)
    for r in recs:
        waves[r.root].append(r)
    assert len(waves) == 2
    for n, (root, rs) in enumerate(sorted(waves.items())):
        assert {(r.name, r.parent) for r in rs} == WAVE
        assert len(rs) == len(WAVE)               # one chunk of the encoder
        by = {r.name: r for r in rs}
        flush = by["scheduler.flush"]
        assert flush.attrs == {"wave": 1 + n, "q": 16, "level": 0}
        for r in rs:
            assert r.start_ns <= r.end_ns
            if r.parent is not None:
                p = by[r.parent]
                assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    s = tracing.summary()
    assert s["active"] is True
    assert {k: v["count"] for k, v in s["spans"].items()} == {
        name: 2 for name, _ in WAVE}
    syncs = s["counters"][tracing.HOST_SYNCS]
    assert syncs["sites"] == {k: 2 * v for k, v in WAVE_SYNCS.items()}
    assert syncs["total"] == 2 * sum(WAVE_SYNCS.values())


def _lm_and_step(seed=0):
    cfg = reduced(get_config("h2o-danube-1.8b"), remat=True)
    lm = M.init_params(cfg, seed=seed, device="cpu")
    opt = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = O.init(dict(lm.named_parameters()))
    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, 32, 2, seed=3))
    batches = [{k: torch.from_numpy(v) for k, v in stream.batch(i).items()}
               for i in range(2)]
    return lm, state, make_train_step(cfg, opt), batches


def test_step_spans_nest_and_carry_the_step_id(clean):
    lm, state, step, batches = _lm_and_step()
    tracing.enable()
    for b in batches:
        step(lm, state, b)
    steps = collections.defaultdict(set)
    for r in tracing.records():
        steps[r.root].add((r.name, r.parent))
    assert list(steps.values()) == [STEP, STEP]
    # RoPE's copy of its frequencies, for q and k in each of the two
    # layers, in the forward and again in the remat's recompute
    syncs = tracing.summary()["counters"][tracing.HOST_SYNCS]
    assert syncs["sites"] == {"train.forward": 8, "train.backward": 8}


def test_a_count_on_a_thread_without_spans_takes_the_latest_open(clean):
    """Autograd runs a CUDA backward on a thread of its own: what it
    counts goes to the span the caller's thread has open."""
    import threading
    tracing.enable()
    tracing.count("c")
    with tracing.span("outer"), tracing.span("inner"):
        t = threading.Thread(target=tracing.count, args=("c", 2))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert tracing.summary()["counters"]["c"]["sites"] == {"": 1,
                                                           "inner": 2}


def test_ring_keeps_its_capacity(clean):
    tracing.enable()
    n = 100_000
    for i in range(n):
        with tracing.span("s", i=i):
            pass
    recs = tracing.records()
    assert len(recs) == tracing.CAPACITY
    assert recs[0].attrs["i"] == n - tracing.CAPACITY
    assert recs[-1].attrs["i"] == n - 1
    assert tracing.summary()["spans"]["s"]["count"] == n


def test_record_and_annotation_agree_under_a_cpu_profiler(clean, svc):
    from torch.profiler import ProfilerActivity, profile
    batcher = MicroBatcher(svc, max_batch=8)
    _wave(batcher, _texts(8), np.zeros(8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.active()
        for seed in range(3):
            _wave(batcher, _texts(8, seed), np.zeros(8))
    assert not tracing.active()
    recs = tracing.records()
    assert len(recs) == 3 * len(WAVE)
    marks = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation() and ev.name().startswith(tracing.PREFIX) \
                and str(ev.device_type()).endswith("CPU"):
            marks[ev.name()[len(tracing.PREFIX):]].append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    mine = collections.defaultdict(list)
    for r in recs:
        mine[r.name].append((r.start_ns, r.end_ns))
    assert set(marks) == set(mine)
    gaps = []
    for name, spans in mine.items():
        assert len(marks[name]) == len(spans), name
        for (s0, e0), (s1, e1) in zip(sorted(spans), sorted(marks[name])):
            gaps += [abs(s0 - s1), abs(e0 - e1)]
    # the median, as on the card: a host shared with other work stalls a
    # call now and then, and a profiler's first annotation sets itself up
    # inside its enter
    assert np.median(gaps) < 50_000, sorted(gaps)


def _fields(res):
    return [(r.model, r.predicted_score, r.predicted_cost, r.lam,
             r.confidence, r.s_row.tobytes(), r.c_row.tobytes(),
             r.request.prompt_tokens.tobytes(), r.degradation) for r in res]


def test_route_wave_bitwise_equal_with_tracing_on_and_off(clean, svc):
    texts, lams = _texts(32, 9), np.linspace(0, 4, 32)
    batcher = MicroBatcher(svc, max_batch=32)
    off = _wave(batcher, texts, lams)
    tracing.enable()
    on = _wave(batcher, texts, lams)
    tracing.disable()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _wave(batcher, texts, lams)
    assert tracing.records()
    assert _fields(on) == _fields(off) == _fields(profiled)


def test_train_step_bitwise_equal_with_tracing_on_and_off(clean):
    runs = []
    for on in (False, True):
        if on:
            tracing.enable()
        lm, state, step, batches = _lm_and_step()
        losses = [step(lm, state, b)["loss"] for b in batches]
        runs.append((losses, dict(lm.named_parameters()), state))
        tracing.disable()
    (l0, p0, s0), (l1, p1, s1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
        for k in ("m", "v", "master"):
            assert torch.equal(s0[k][name], s1[k][name]), (k, name)


@pytest.mark.gpu
def test_gpu_host_syncs_match_the_sync_counter(clean):
    """One backlog-sized wave (1,024 texts, kNN 100 over 50,000 rows) on
    the card under `SyncCounter`: every synchronising call it reports is
    counted by ``host_syncs``, at its site, and no more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the sync debug mode is CUDA's")
    from repro_torch.analysis.sanitizers import SyncCounter
    svc = _service("cuda", n=50_000, k=100)
    batcher = MicroBatcher(svc, max_batch=1024)
    texts, lams = _texts(1024, 4), np.linspace(0, 4, 1024)
    _wave(batcher, texts, lams)                  # builds, fills the caches
    torch.cuda.synchronize()
    tracing.enable()
    t0 = time.perf_counter()
    with SyncCounter() as sc:
        _wave(batcher, texts, lams)
    assert time.perf_counter() - t0 < 60
    syncs = tracing.summary()["counters"][tracing.HOST_SYNCS]
    assert len(sc.records) == syncs["total"], (sc.by_site(), syncs)
    assert syncs["sites"] == WAVE_SYNCS
