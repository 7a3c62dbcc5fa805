"""The port's scheduling and fault layer against the JAX package: the
degradation ladder, the dispatch policy (its fit, lookups, artifact round
trip and ``lane_pad``), degraded routes, the micro-batcher's waves and the
wave scheduler's tokens, and `RouterService.stats()`.

The same inputs, made from a numpy seed, go through both packages.  Levels,
policy tables, backends, choices, models, lambdas, degradation levels,
tickets and greedy tokens must be equal; utilities, confidences and
predicted scores allclose at 1e-5 (the tolerance of
`test_torch_routing.py`: f32 weighted means over k neighbours).  The
services' engines and encoders share weights through `params_from_jax`,
and the reference engine waits for each decode step (its host token
buffer races with the asynchronous step otherwise)."""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.dataset import RoutingDataset as JaxDataset  # noqa: E402
from repro.core.routers import dispatch as jdispatch  # noqa: E402
from repro.core.routers import load_router as jax_load  # noqa: E402
from repro.core.routers import make_router as jax_make  # noqa: E402
from repro.core.routers import save_router as jax_save  # noqa: E402
from repro.core.routers.knn import KNNRouter as JaxKNN  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.dataset import RoutingDataset  # noqa: E402
from repro_torch.core.routers import (KNNRouter, load_router,  # noqa: E402
                                      make_router, save_router)
from repro_torch.core.routers import dispatch as tdispatch  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.router_service import (RouterService,  # noqa: E402
                                                to_jsonable)

TOL = 1e-5
FIXTURES = Path(__file__).resolve().parent / "fixtures"
POOL = ["qwen3-4b", "h2o-danube-1.8b"]
TEXTS = [f"{t} request number {i}" for i, t in enumerate(
    ["python programming", "world history", "algebra proofs",
     "poetry writing", "biology facts"] * 2)]
LAMS = [0.0, 1.0, None, 50.0, 0.5, 200.0, 0.0, None, 2.0, 100.0]


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_batch,levels", [(1, 4), (8, 4), (64, 4),
                                              (8, 2)])
def test_ladder_levels_match_reference(max_batch, levels):
    """``level_for`` over a grid of queue depth x headroom (thresholds and
    random points), with the default ladder and one cut to two rungs;
    ``ladder[i]`` clamps out-of-range levels the same way."""
    rng = np.random.default_rng(max_batch + levels)
    depths = np.concatenate([np.arange(0, 10 * max_batch + 2),
                             rng.integers(0, 20 * max_batch, 40)])
    heads = np.concatenate([[1.0, 0.5, 0.4999, 0.25, 0.2499, 0.1, 0.0999,
                             0.0, -1.0], rng.uniform(-0.5, 1.2, 20)])
    jl = jfaults.DegradationLadder(levels=jfaults.DEFAULT_LEVELS[:levels])
    tl = tfaults.DegradationLadder(levels=tfaults.DEFAULT_LEVELS[:levels])
    want = [[jl.level_for(int(d), max_batch, float(h)) for h in heads]
            for d in depths]
    got = [[tl.level_for(int(d), max_batch, float(h)) for h in heads]
           for d in depths]
    assert got == want
    assert {v for row in got for v in row} == set(range(levels))
    for i in range(-3, 8):
        assert dataclasses.asdict(tl[i]) == dataclasses.asdict(jl[i])


# ---------------------------------------------------------------------------
# dispatch policy
# ---------------------------------------------------------------------------

def _measured(seed):
    """Measured cells on a grid of (index, batch, delta fraction): a fixed
    cost plus a per-request one, so per-request p50 falls with the batch."""
    rng = np.random.default_rng(seed)
    rows = []
    for index in ("exact", "ivf", "ivfpq"):
        for batch in (1, 4, 16, 64):
            for delta in (0.0, 0.1, 0.3):
                rows.append({
                    "index": index, "batch": batch, "delta_frac": delta,
                    "backends": {
                        b: {"p50_s": float(rng.uniform(5e-4, 2e-3)
                                           + batch * rng.uniform(1e-5, 1e-4))}
                        for b in jdispatch.POLICY_BACKENDS}})
    return rows


BATCHES = (0, 1, 2, 3, 4, 5, 15, 16, 17, 63, 64, 65, 1000)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_dispatch_policy_matches_reference(seed):
    rows = _measured(seed)
    tiles = {"ivfpq": {"lane_pad": 16, "block_q": 32, "probe_chunk": 4}}
    jp = jdispatch.fit_dispatch_policy(rows, tiles=tiles,
                                       fitted_from={"seed": seed})
    tp = tdispatch.fit_dispatch_policy(rows, tiles=tiles,
                                       fitted_from={"seed": seed})
    assert tp.to_dict() == jp.to_dict()
    assert tp.wave_target_batch > 0 and tp.wave_close_timeout_s > 0
    assert tdispatch.DispatchPolicy.from_dict(jp.to_dict()) == tp
    for index in ("exact", "ivf", "ivfpq", "graph"):
        assert tp.tiles_for(index) == jp.tiles_for(index)
        for n in BATCHES:
            for delta in (0.0, 0.05, 0.1, 0.2, 0.3, 0.9):
                assert tp.backend_for(index, n, delta) == \
                    jp.backend_for(index, n, delta), (index, n, delta)
                assert tp.exec_backend_for(index, n, delta) == \
                    jp.exec_backend_for(index, n, delta)
    bad = [dict(rows[0], backends={"warp": {"p50_s": 0.0}})]
    for mod in (jdispatch, tdispatch):
        with pytest.raises(ValueError, match="unknown policy backend"):
            mod.fit_dispatch_policy(bad)


@pytest.mark.parametrize("kw", [{}, {"backend": "tiles"},
                                {"use_pallas": True}])
def test_resolve_backend_matches_reference(kw):
    """With and without a fitted policy, an explicit backend and
    ``use_pallas``: `resolve_backend` and `exec_backend` give the
    reference's pick at every batch size."""
    d = _measured(3)
    jp = jdispatch.fit_dispatch_policy(d)
    tp = tdispatch.fit_dispatch_policy(d)
    for index in ("exact", "ivf", "ivfpq"):
        jr = JaxKNN(k=10, index=index, **kw)
        tr = KNNRouter(k=10, index=index, device="cpu", **kw)
        assert tr.exec_backend == jr.exec_backend
        for pol in (None, (jp, tp)):
            jr.dispatch_policy, tr.dispatch_policy = pol or (None, None)
            for n in BATCHES + (None,):
                assert tr.resolve_backend(n) == jr.resolve_backend(n), \
                    (index, kw, pol is not None, n)


def _datasets(N=900, D=32, M=3, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, D)) * 3
    topic = rng.integers(0, 8, N)
    X = (centers[topic] + rng.normal(size=(N, D))).astype(np.float32)
    S = np.clip(rng.uniform(0.2, 1, (8, M))[topic]
                + rng.normal(0, 0.05, (N, M)), 0, 1).astype(np.float32)
    C = np.tile(rng.uniform(0.001, 0.01, M), (N, 1)).astype(np.float32)
    names = [f"m{i}" for i in range(M)]
    Q = (centers[rng.integers(0, 8, 24)]
         + rng.normal(size=(24, D))).astype(np.float32)
    return (JaxDataset("d", X, S, C, names),
            RoutingDataset("d", X, S, C, names), Q)


@pytest.fixture(scope="module")
def data():
    return _datasets()


POLICY = {"cells": {"ivfpq": {"16": {"0": "staged"}, "64": {"0": "fused"}}},
          "batch_edges": [16, 64], "delta_edges": [0.0],
          "wave_close_timeout_s": 0.0025, "wave_target_batch": 16,
          "tiles": {"ivfpq": {"lane_pad": 16, "probe_chunk": 4},
                    "ivf": {"lane_pad": 16, "block_q": 32}},
          "fitted_from": {"host": "test"}}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_policy_artifact_round_trip(direction, data, tmp_path):
    """A policy saved by either package loads in the other as an equal
    `DispatchPolicy`, and a router saved with it predicts the same."""
    jds, tds, Q = data
    if direction == "jax_to_port":
        r = jax_make("knn20-ivfpq@m=8").fit(jds)
        r.dispatch_policy = jdispatch.DispatchPolicy.from_dict(POLICY)
        other = load_router(jax_save(r, tmp_path / "a"), device="cpu")
        assert isinstance(other.dispatch_policy, tdispatch.DispatchPolicy)
    else:
        r = make_router("knn20-ivfpq@m=8", device="cpu").fit(tds)
        r.dispatch_policy = tdispatch.DispatchPolicy.from_dict(POLICY)
        other = jax_load(save_router(r, tmp_path / "a"))
        assert isinstance(other.dispatch_policy, jdispatch.DispatchPolicy)
    assert other.dispatch_policy.to_dict() == r.dispatch_policy.to_dict()
    assert other.resolve_backend(16) == r.resolve_backend(16) == "tiles"
    for x, y in zip(other.predict_with_confidence(Q),
                    r.predict_with_confidence(Q)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=TOL)


@pytest.mark.parametrize("version", [1, 2])
def test_fixture_artifacts_load_without_a_policy(version):
    path = FIXTURES / f"artifact_v{version}"
    assert load_router(path, device="cpu").dispatch_policy is None
    assert jax_load(path).dispatch_policy is None


@pytest.mark.parametrize("index", ["ivf", "ivfpq"])
def test_policy_lane_pad_gives_the_reference_index_bytes(index, data):
    """A policy's ``lane_pad`` reaches the index built at ``fit``: the
    port's lists equal the reference's built with the same ``lane_pad``,
    byte for byte; ``block_q`` / ``probe_chunk`` change nothing here."""
    jds, tds, Q = data
    kw = {"m": 8} if index == "ivfpq" else {}
    jr = JaxKNN(k=20, index=index, **kw)
    tr = KNNRouter(k=20, index=index, device="cpu", **kw)
    jr.dispatch_policy = jdispatch.DispatchPolicy.from_dict(POLICY)
    tr.dispatch_policy = tdispatch.DispatchPolicy.from_dict(POLICY)
    jr.fit(jds)
    tr.fit(tds)
    plain = KNNRouter(k=20, index=index, device="cpu", **kw).fit(tds)
    assert tr._ivf.list_size % 16 == 0
    assert tr._ivf.list_size != plain._ivf.list_size
    field = "codes_h" if index == "ivfpq" else "sup_h"
    a, b = getattr(tr._ivf, field), getattr(jr._ivf, field)
    assert a.shape == b.shape and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(tr._ivf.ids_h, jr._ivf.ids_h)
    lam = np.linspace(0, 50, len(Q)).astype(np.float32)
    jo, to = jr.serve_fused(Q, lam), tr.serve_fused(Q, lam)
    np.testing.assert_array_equal(to[0], jo[0])


# ---------------------------------------------------------------------------
# degraded routes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def degraded_pair(data, tmp_path_factory):
    """One artifact per index, saved by the reference, loaded in both."""
    jds, _, _ = data
    out = {}
    for index, spec in (("ivf", "knn20-ivf"), ("ivfpq", "knn20-ivfpq@m=8")):
        path = jax_save(jax_make(spec).fit(jds),
                        tmp_path_factory.mktemp(index))
        out[index] = (jax_load(path), load_router(path, device="cpu"))
    return out


@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("index", ["ivf", "ivfpq"])
def test_degraded_routes_match_reference(index, level, data, degraded_pair):
    _, _, Q = data
    jr, tr = degraded_pair[index]
    jl, tl = jfaults.DegradationLadder()[level], \
        tfaults.DegradationLadder()[level]
    lam = np.linspace(0, 50, len(Q)).astype(np.float32)
    saved = (tr.nprobe, tr.rerank)
    with jr.degraded(jl), tr.degraded(tl):
        assert (tr.nprobe, tr.rerank) == (jr.nprobe, jr.rerank)
        jo, to = jr.serve_fused(Q, lam), tr.serve_fused(Q, lam)
    assert (tr.nprobe, tr.rerank) == saved == (jr.nprobe, jr.rerank)
    np.testing.assert_array_equal(to[0], jo[0])
    for t, j in zip(to[1:], jo[1:]):
        np.testing.assert_allclose(t, np.asarray(j), atol=TOL)


@pytest.mark.parametrize("index", ["ivf", "ivfpq"])
def test_degraded_restores_after_an_exception(index, degraded_pair):
    _, tr = degraded_pair[index]
    saved = (tr.nprobe, tr.rerank, tr._skip_delta)
    with pytest.raises(RuntimeError, match="inside"):
        with tr.degraded(tfaults.DegradationLadder()[3]):
            assert (tr.nprobe, tr.rerank, tr._skip_delta) == (
                max(1, round(saved[0] * 0.25)), 0, True)
            raise RuntimeError("raised inside the block")
    assert (tr.nprobe, tr.rerank, tr._skip_delta) == saved


# ---------------------------------------------------------------------------
# micro-batcher and wave scheduler over same-weight services
# ---------------------------------------------------------------------------

def _jax_encoder_params():
    from repro.configs.base import ATTN_DENSE, ModelConfig
    from repro.models import model as jax_M
    cfg = ModelConfig(
        name="query-encoder", arch_type="dense", n_layers=2, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=1536, vocab_size=8192,
        pattern=(ATTN_DENSE,), n_groups=2, dtype="float32", remat=False)
    return jax.tree.map(np.asarray,
                        jax_M.init_params(jax.random.PRNGKey(7), cfg))


def _synchronous(fn):
    return lambda *args: jax.block_until_ready(fn(*args))


@pytest.fixture(scope="module")
def services():
    """(reference service, port service): `knn10-ivf` over the same
    support set, encoder weights and engine weights."""
    from repro.launch.serve import build_support as jax_build_support
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro.serving.router_service import RouterService as JaxService
    from repro_torch.serving.encoder import ENCODER_CFG, QueryEncoder

    j_engines, t_engines = {}, {}
    for i, name in enumerate(POOL):
        je = JaxEngine(jax_reduced(jax_get_config(name)), max_slots=2,
                       cache_len=48, seed=i)
        je._decode = _synchronous(je._decode)
        j_engines[name] = je
        t_engines[name] = ServingEngine(
            reduced(get_config(name)),
            params_from_jax(jax.tree.map(np.asarray, je.params),
                            reduced(get_config(name))),
            max_slots=2, cache_len=48, device="cpu")
    jds = jax_build_support(POOL, n=200)
    tds = RoutingDataset(jds.name, jds.embeddings, jds.scores, jds.costs,
                         list(jds.model_names))
    jsvc = JaxService(jax_make("knn10-ivf"), j_engines, ds=jds)
    tsvc = RouterService(
        make_router("knn10-ivf", device="cpu"), t_engines, ds=tds,
        encoder=QueryEncoder(params_from_jax(_jax_encoder_params(),
                                             ENCODER_CFG), device="cpu"))
    return jsvc, tsvc


def _count_routes(svc):
    """Wrap ``route_fused`` with a call counter (the batcher reaches it
    through ``submit_texts``)."""
    inner = svc.route_fused
    calls = []

    def counted(*a, **kw):
        calls.append(kw.get("degrade", 0))
        return inner(*a, **kw)
    svc.route_fused = counted
    return calls


def _scenario(sched, faults, svc):
    """One scripted run of a batcher under an injected clock: partial
    flushes, the ladder, shedding, cancel and close.  Returns (events,
    predicted scores, route calls, batcher)."""
    t = [0.0]
    calls = _count_routes(svc)
    b = sched.MicroBatcher(svc, max_batch=3, max_new_tokens=2,
                           close_timeout_s=0.5, clock=lambda: t[0],
                           max_pending=5, deadline_s=2.0,
                           ladder=faults.DegradationLadder())
    ev, scores = [], []

    def res(rs):
        scores.extend(r.predicted_score for r in rs)
        return [(r.model, round(r.lam, 6), r.degradation) for r in rs]

    tickets = [b.submit(TEXTS[i], LAMS[i]) for i in range(5)]
    ev.append(("tickets", tickets, b.pending()))
    try:
        b.submit(TEXTS[5])
    except faults.Overloaded as exc:
        ev.append(("shed", exc.pending, round(exc.retry_after_s, 9), b.shed))
    ev.append(("ready full", b.ready()))
    ev.append(("flush", res(b.maybe_flush()), b.last_degradation))
    ev.append(("ready partial", b.ready(), b.maybe_flush()))
    # a queued ticket leaves the queue; a flushed one is only forgotten
    ev.append(("cancel", b.cancel(tickets[4]), b.cancel(tickets[0]),
               b.pending()))
    t[0] = 0.49
    ev.append(("ready early", b.ready()))
    t[0] = 1.2                       # headroom 0.4: the ladder's rung 1
    ev.append(("flush timed", res(b.maybe_flush()), b.last_degradation))
    more = [b.submit(TEXTS[i], LAMS[i]) for i in range(5, 10)]
    t[0] = 3.15                      # overdue: rung 3
    ev.append(("flush late", res(b.flush()), b.last_degradation))
    ev.append(("claims", [res([r])[0] if (r := b.pop_result(tk)) else None
                          for tk in tickets + more]))
    late = b.submit(TEXTS[0], 0.0)
    b.close()
    ev.append(("closed", b.pending(), b.flushes, b.routed, b.shed,
               b.degraded_waves, res([b.pop_result(late)])))
    try:
        b.submit("after close")
    except RuntimeError as exc:
        ev.append(("refused", "closed" in str(exc)))
    b.close()                        # idempotent
    return ev, scores, calls, b


def test_microbatcher_waves_match_reference(services):
    jsvc, tsvc = services
    try:
        jev, js, jcalls, jb = _scenario(jsched, jfaults, jsvc)
        tev, ts, tcalls, tb = _scenario(tsched, tfaults, tsvc)
    finally:
        for svc in services:
            svc.__dict__.pop("route_fused", None)
    assert tev == jev
    np.testing.assert_allclose(ts, js, atol=TOL)
    # one route_fused a flush, at the flush's ladder level
    assert len(tcalls) == tb.flushes == len(jcalls) == jb.flushes == 4
    assert tcalls == jcalls
    assert {0, 1, 3} <= set(tcalls)
    assert len({m for e in tev if e[0] == "claims" for m in
                [c[0] for c in e[1] if c]}) == 2     # both engines chosen


def test_microbatcher_from_policy_matches_reference(services):
    jsvc, tsvc = services
    d = _measured(4)
    jp, tp = jdispatch.fit_dispatch_policy(d), tdispatch.fit_dispatch_policy(d)
    try:
        for jpol, tpol in ((None, None), (jp, tp)):
            jsvc.router.dispatch_policy = jpol
            tsvc.router.dispatch_policy = tpol
            for over in ({}, {"max_batch": 3, "max_pending": 7}):
                jb = jsched.MicroBatcher.from_policy(jsvc, **over)
                tb = tsched.MicroBatcher.from_policy(tsvc, **over)
                got = (tb.max_batch, tb.close_timeout_s, tb.max_pending)
                assert got == (jb.max_batch, jb.close_timeout_s,
                               jb.max_pending)
            if tpol is not None:
                tb = tsched.MicroBatcher.from_policy(tsvc)
                assert (tb.max_batch, tb.close_timeout_s) == (
                    tp.wave_target_batch, tp.wave_close_timeout_s)
    finally:
        jsvc.router.dispatch_policy = tsvc.router.dispatch_policy = None


def test_wave_scheduler_drain_tokens_match_reference(services):
    """Texts submitted through each package's `WaveScheduler(batcher=...)`
    drain to the same greedy tokens, and `SchedulerStats` are equal."""
    outs = []
    for sched, svc in zip((jsched, tsched), services):
        b = sched.MicroBatcher(svc, max_batch=4, max_new_tokens=3)
        ws = sched.WaveScheduler(svc.engines, batcher=b)
        for text, lam in zip(TEXTS[:6], LAMS[:6]):
            ws.submit_text(text, lam)
        stats = ws.drain()
        rs = [b.pop_result(t) for t in range(6)]
        outs.append((dataclasses.asdict(stats), b.flushes,
                     [(r.model, r.request.done, r.request.output_tokens)
                      for r in rs]))
    assert outs[1] == outs[0]
    assert outs[1][1] == 2 and outs[1][0]["completed"] == 6


def test_stats_keys_and_json_round_trip(services, monkeypatch):
    """`stats()` has the reference's keys, and round-trips through
    ``json.dumps`` with torch tensors planted in router attributes."""
    jsvc, tsvc = services
    jst, tst = jsvc.stats(), tsvc.stats()
    assert set(tst) == set(jst)
    assert set(tst["engines"]["qwen3-4b"]) == set(jst["engines"]["qwen3-4b"])
    assert tst["durability"] is None and tst["recovery"] is None
    assert tsvc.recovery_status() is None
    monkeypatch.setattr(KNNRouter, "support_size",
                        property(lambda self: torch.tensor(140)))
    monkeypatch.setattr(tsvc, "default_lam", torch.tensor(0.25))
    st = json.loads(json.dumps(tsvc.stats()))
    assert st["support_size"] == 140 and st["default_lam"] == 0.25
    odd = {"a": torch.arange(6).reshape(2, 3), "b": torch.tensor(float("nan")),
           "c": np.float32(2.5), "d": (np.int64(3), torch.tensor([True]))}
    assert json.loads(json.dumps(to_jsonable(odd))) == {
        "a": [[0, 1, 2], [3, 4, 5]], "b": None, "c": 2.5, "d": [3, [True]]}


def test_route_embeddings_and_submit_texts_degrade(services):
    jsvc, tsvc = services
    emb = tsvc.encoder.embed_texts(TEXTS)
    lam = np.asarray([0.0 if v is None else v for v in LAMS], np.float32)
    np.testing.assert_array_equal(tsvc.route_embeddings(emb, lam),
                                  jsvc.route_embeddings(emb, lam))
    for level in (0, 2):
        rs = tsvc.submit_texts(TEXTS[:3], lam=lam[:3], degrade=level)
        assert [r.degradation for r in rs] == [level] * 3
    assert tsvc.router.nprobe == jsvc.router.nprobe
