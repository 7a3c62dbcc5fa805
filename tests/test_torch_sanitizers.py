"""The port's runtime sanitizers (`repro_torch.analysis.sanitizers`) and
the retrieval autotuner (`repro_torch.kernels.knn_ivf.autotune`) on the
CPU.  Fixtures are defined here (the reference's live in
`tests/conftest.py`, which the port leaves alone).

`SyncCounter` needs a CUDA build of torch for ``set_sync_debug_mode``;
here its recording is driven by the warning torch raises, emitted from a
line of a port file, with the mode calls stubbed.  The card's run of it
is `tests/test_torch_gpu.py` and `chip_smoke.py` phase 11."""
import json
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import sanitizers as S  # noqa: E402
from repro_torch.core.dataset import RoutingDataset  # noqa: E402
from repro_torch.core.routers.dispatch import DispatchPolicy  # noqa: E402
from repro_torch.core.routers.knn import KNNRouter  # noqa: E402
from repro_torch.kernels.knn_ivf import autotune as AT  # noqa: E402
from repro_torch.kernels.knn_ivf import ops as T  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
KNN = SRC / "repro_torch/core/routers/knn.py"
D = 24
MODELS = ["m-a", "m-b", "m-c"]
SYNC_MSG = ("called a synchronizing CUDA operation (Triggered internally at "
            "c10/cuda/CUDAFunctions.cpp)")


# ---- fixtures (the port's counterparts of conftest's) ----

@pytest.fixture
def watchdog():
    """``watchdog([fn, fn, ...], timeout=30)`` runs the thunks on
    concurrent threads and raises DeadlockError with an all-thread stack
    dump if they don't all finish in time."""
    return S.run_with_watchdog


@pytest.fixture
def cache_counter():
    """``cc = cache_counter({"knn": router})`` -> a CacheCounter over the
    port's caches, snapshotted; growth() must stay empty across waves."""
    def make(routers):
        cc = S.CacheCounter(S.port_caches(routers))
        cc.snapshot()
        return cc
    return make


@pytest.fixture
def sync_counter(monkeypatch):
    """A `SyncCounter` whose mode calls are stubbed (no CUDA here), and an
    ``emit(path, line)`` that raises torch's sync warning from that line of
    a port file, as the card's runtime does."""
    modes = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def emit(path, line, msg=SYNC_MSG):
        code = "\n" * (line - 1) + "warn(msg, UserWarning)\n"
        exec(compile(code, str(path), "exec"),
             {"warn": warnings.warn, "msg": msg})
    return S.SyncCounter, emit, modes


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(1)
    n = 400
    return RoutingDataset(
        "sanitizers", rng.normal(size=(n, D)).astype(np.float32),
        rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
        rng.uniform(0.001, 0.01, (n, 3)).astype(np.float32), MODELS)


@pytest.fixture(scope="module")
def X():
    return np.random.default_rng(7).normal(size=(16, D)).astype(np.float32)


LAM = np.full(16, 0.5, np.float32)


def _line_of(path, needle):
    for i, ln in enumerate(Path(path).read_text().splitlines(), start=1):
        if needle in ln:
            return i
    raise AssertionError(needle)


# ---------------------------------------------------------------------------
# SyncCounter + allowed_by_pragma
# ---------------------------------------------------------------------------

def test_sync_counter_records_port_frames_and_restores(sync_counter):
    SyncCounter, emit, modes = sync_counter
    end = _line_of(KNN, "return tuple(o.cpu().numpy() for o in out)")
    with SyncCounter() as sc:
        emit(KNN, end)
        emit(KNN, end)
        with pytest.warns(UserWarning, match="unrelated"):
            emit(KNN, 3, msg="unrelated warning")   # passed through
    assert modes == ["warn", 0]                      # set, then restored
    assert sc.by_site() == {f"repro_torch/core/routers/knn.py:{end}": 2}
    assert [r.message for r in sc.records] == [SYNC_MSG] * 2


def test_sync_counter_restores_the_mode_when_the_block_raises(sync_counter):
    SyncCounter, emit, modes = sync_counter
    with pytest.raises(RuntimeError):
        with SyncCounter():
            raise RuntimeError("boom")
    assert modes == ["warn", 0]


def test_allowed_by_pragma_on_synthetic_records():
    """A record on an allow-host line (trailing or stand-alone pragma, or
    inside a statement whose first line is covered) is allowed; one on a
    plain line, or outside the port, is returned."""
    end = _line_of(KNN, "return tuple(o.cpu().numpy() for o in out)")
    lam = _line_of(KNN, "lam_t = torch.from_numpy(")
    plain = _line_of(KNN, "s_hat, c_hat = _utility(")
    rel = "repro_torch/core/routers/knn.py"
    recs = [S.SyncRecord(rel, end, SYNC_MSG),           # stand-alone pragma
            S.SyncRecord(rel, lam + 1, SYNC_MSG),       # 2nd line of a call
            S.SyncRecord(rel, plain, SYNC_MSG),         # no pragma
            S.SyncRecord("repro/core/routers/knn.py", end, SYNC_MSG),
            S.SyncRecord("/usr/lib/python3/site.py", 1, SYNC_MSG)]
    bad = S.allowed_by_pragma(recs)
    assert bad == recs[2:]
    assert S.allowed_by_pragma(recs[:2], root=SRC) == []


def test_allowed_by_pragma_reads_the_tree_given(tmp_path):
    mod = tmp_path / "repro_torch" / "m.py"
    mod.parent.mkdir()
    mod.write_text("a = 1\nb = x.cpu()  # repro: allow-host: the one copy\n"
                   "c = (y\n     .cpu())\n")
    recs = [S.SyncRecord("repro_torch/m.py", n, SYNC_MSG) for n in (2, 4)]
    assert S.allowed_by_pragma(recs, root=tmp_path) == recs[1:]


def test_every_r1_allow_host_site_is_a_pragma_the_runtime_accepts():
    """Every line R1 lets through on its pragma is a line the runtime check
    accepts too: the two gates read one index."""
    from repro_torch.analysis.core import Pragmas
    for path in (SRC / "repro_torch").rglob("*.py"):
        pr = Pragmas(path.read_text())
        rel = path.relative_to(SRC).as_posix()
        lines = pr.lines.get("allow-host", set())
        recs = [S.SyncRecord(rel, n, SYNC_MSG) for n in sorted(lines)]
        assert S.allowed_by_pragma(recs) == [], rel


# ---------------------------------------------------------------------------
# CacheCounter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", ["exact", "ivf", "ivfpq"])
def test_cache_counter_stable_over_repeated_cpu_waves(ds, X, index,
                                                      cache_counter):
    from repro_torch.serving.router_service import RouterService
    r = KNNRouter(k=5, index=index, m=4 if index == "ivfpq" else None,
                  device="cpu").fit(ds)
    svc = RouterService(r, {m: None for m in MODELS})
    first = svc.route_fused(X, LAM)              # warm-up wave fills caches
    cc = cache_counter({index: r})
    assert cc.snapshot()[f"router_dev_bytes[{index}]"] > 0
    for _ in range(5):
        out = svc.route_fused(X, LAM)
        np.testing.assert_array_equal(out[0], first[0])
    assert cc.growth() == {} and cc.total() == 0


def test_cache_counter_reports_growth(ds, X, cache_counter):
    r = KNNRouter(k=5, index="exact", device="cpu").fit(ds)
    r.serve_fused(X, LAM)
    cc = cache_counter({"exact": r})
    rng = np.random.default_rng(2)
    r.partial_fit(rng.normal(size=(300, D)).astype(np.float32),
                  rng.uniform(size=(300, 3)).astype(np.float32))
    r.serve_fused(X, LAM)
    grown = cc.growth()
    assert list(grown) == ["router_dev_bytes[exact]"] and grown[
        "router_dev_bytes[exact]"] > 0
    counts = {"n": 0}
    cc2 = S.CacheCounter({"graphs": lambda: counts["n"]})
    cc2.snapshot()
    counts["n"] += 2
    assert cc2.growth() == {"graphs": 2} and cc2.total() == 2


def test_graph_capture_count_is_a_port_cache():
    from repro_torch.core.routers import nn_utils
    sizes = S.port_caches()
    assert set(sizes) == {"kernel_libraries", "cuda_graphs"}
    assert sizes["cuda_graphs"]() == nn_utils._GraphedStep.captures


# ---------------------------------------------------------------------------
# the watchdog over the streaming index
# ---------------------------------------------------------------------------

def test_watchdog_over_dynamic_index_interleavings(watchdog):
    """Appends, a background compaction, searches on both backends and
    the snapshot readers run concurrently on the port's DynamicIVFIndex;
    every row appended is served afterwards."""
    rng = np.random.default_rng(5)
    sup = rng.normal(size=(500, 16)).astype(np.float32)
    dyn = T.DynamicIVFIndex(T.build_ivf_index(sup, seed=0, device="cpu"),
                            delta_cap=64, build_kw={"seed": 0})
    q = rng.normal(size=(8, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    batches = [rng.normal(size=(40, 16)).astype(np.float32)
               for _ in range(6)]

    def appender():
        for b in batches:
            dyn.append(b)
            dyn.maybe_recluster(sync=False)

    def searcher(backend):
        def run():
            for _ in range(10):
                s, i = T.ivf_topk(q, dyn, 10, nprobe=4, backend=backend)
                assert s.shape == (8, 10)
                assert int(i.max()) < dyn.n_rows
        return run

    def reader():
        for _ in range(20):
            dyn.delta_occupancy()
            dyn.fused_state()
            assert dyn.n_rows >= 500

    watchdog([appender, searcher("fused"), searcher("host"), reader],
             timeout=120)
    dyn.join_recluster()
    assert dyn.n_rows == 500 + 240 == len(dyn.all_rows())


def test_watchdog_reports_a_real_deadlock(watchdog):
    a, b = threading.Lock(), threading.Lock()
    both = threading.Barrier(2)

    def left():
        with a:
            both.wait()
            with b:
                pass

    def right():
        with b:
            both.wait()
            with a:
                pass

    with pytest.raises(S.DeadlockError, match="live stacks") as err:
        watchdog([left, right], timeout=2)
    assert "watchdog-worker-0" in str(err.value)
    assert "in left" in str(err.value) and "in right" in str(err.value)


def test_watchdog_reraises_a_worker_error(watchdog):
    def bad():
        raise ValueError("worker failed")
    with pytest.raises(ValueError, match="worker failed"):
        watchdog([bad, lambda: None], timeout=10)


# ---------------------------------------------------------------------------
# the autotuner and the tiles it feeds
# ---------------------------------------------------------------------------

def test_autotune_router_smoke(ds):
    """The reference's `test_dispatch.py` smoke on the port: the chosen
    values among the candidates, a p50 per candidate, {} for exact."""
    r = KNNRouter(k=5, index="ivfpq", m=4, device="cpu").fit(ds)
    q = np.random.default_rng(3).normal(size=(8, D)).astype(np.float32)
    t = AT.autotune_router(r, q, repeats=2, block_qs=(16, 32),
                           probe_chunks=(0, 2))
    assert t["block_q"] in (16, 32)
    assert t["probe_chunk"] in (0, 2)
    assert set(t["sweep"]["block_q"]) == {16, 32}
    for cand in t["sweep"]["block_q"].values():
        assert cand["p50_s"] > 0
    exact = KNNRouter(k=5, index="exact", device="cpu").fit(ds)
    assert AT.autotune_router(exact, q) == {}


def _shape(d):
    """A dict's keys all the way down (values dropped)."""
    if isinstance(d, dict):
        return {k: _shape(v) for k, v in d.items()}
    return type(d).__name__ if isinstance(d, str) else "num"


def test_autotune_router_dict_shape_matches_the_reference(ds):
    """Same fitted IVF-PQ data through both packages' `autotune_router`:
    the same keys, candidates and per-candidate fields."""
    from repro.core.dataset import RoutingDataset as JD
    from repro.core.routers import KNNRouter as JK
    from repro.kernels.knn_ivf.autotune import autotune_router as ref_tune
    q = np.random.default_rng(3).normal(size=(8, D)).astype(np.float32)
    kw = dict(repeats=2, block_qs=(16, 32), probe_chunks=(0, 2))
    ref = ref_tune(JK(k=5, index="ivfpq", m=4).fit(
        JD(ds.name, ds.embeddings, ds.scores, ds.costs, ds.model_names)), q, **kw)
    port = AT.autotune_router(
        KNNRouter(k=5, index="ivfpq", m=4, device="cpu").fit(ds), q, **kw)
    assert _shape(port) == _shape(ref)


def test_autotune_ivf_sweeps_every_instantiated_tile(ds):
    r = KNNRouter(k=5, index="ivf", device="cpu", online=True).fit(ds)
    q = np.random.default_rng(4).normal(size=(16, D)).astype(np.float32)
    t = AT.autotune_router(r, q, repeats=1)
    assert set(t) == {"block_q", "sweep"}
    assert set(t["sweep"]["block_q"]) == set(T.IVF_BLOCK_QS)
    assert t["block_q"] in T.IVF_BLOCK_QS
    with pytest.raises(ValueError, match="block_q"):
        AT.autotune_router(r, q, repeats=1, block_qs=(16, 12))


def test_roofline_terms_follow_the_tiles(ds, monkeypatch):
    """Kernel 4's reads fall as the tile grows (a list shared by a tile's
    queries is read once a tile), no tile reckons the batch's; kernel 5's
    three launches (where its shape takes them) move the table and keys
    through HBM, the fused path does not."""
    r = KNNRouter(k=5, index="ivf", device="cpu").fit(ds)
    q = np.random.default_rng(6).normal(size=(64, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    by = {b: AT.roofline_terms(r._ivf, q, 5, nprobe=r.nprobe, block_q=b)
          for b in T.IVF_BLOCK_QS}
    reads = [by[b]["bytes"] for b in T.IVF_BLOCK_QS]
    assert reads == sorted(reads, reverse=True) and reads[0] > reads[-1]
    assert len({by[b]["flops"] for b in by}) == 1
    assert AT.roofline_terms(r._ivf, q, 5, nprobe=r.nprobe) == by[64]
    assert AT.roofline_terms(r._ivf, q[:63], 5, nprobe=r.nprobe) == \
        AT.roofline_terms(r._ivf, q[:63], 5, nprobe=r.nprobe, block_q=16)
    for t in by.values():
        assert t["bound"] in ("memory", "compute")
        assert t["t_memory_s"] == pytest.approx(t["bytes"] / 3.35e12)
    pq = KNNRouter(k=5, index="ivfpq", m=4, device="cpu").fit(ds)
    fused = AT.roofline_terms(pq._ivf, q, 5, nprobe=8, rerank=8)
    monkeypatch.setattr(T, "fused_fits", lambda *a, **kw: False)
    three = AT.roofline_terms(pq._ivf, q, 5, nprobe=8, rerank=8)
    assert three["bytes"] > fused["bytes"]
    assert three["flops"] == fused["flops"]


@pytest.mark.parametrize("pq", [False, True])
def test_autotune_lane_pad_on_a_subsample(ds, pq):
    q = np.random.default_rng(8).normal(size=(8, D)).astype(np.float32)
    t = AT.autotune_lane_pad(ds.embeddings, q, 5, pq=pq, m=4 if pq else None,
                             sample=300, repeats=1, device="cpu")
    assert t["chosen"] in (8, 128) and set(t["candidates"]) == {8, 128}
    assert t["candidates"][128]["list_size"] % 128 == 0
    assert t["candidates"][8]["list_size"] % 8 == 0


def test_block_q_validation_never_falls_back():
    q = torch.zeros(2, D)
    probe = torch.zeros(2, 1, dtype=torch.int32)
    sup = torch.zeros(1, 8, D)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    inv = torch.zeros(1, 8)
    for bad in (12, 0, 128, 16.5, True):
        with pytest.raises(ValueError, match="block_q"):
            T.ivf_scan(q, probe, sup, ids, inv, 1, block_q=bad)
    for good in (None, 8, 16, 32, 64):
        T.ivf_scan(q, probe, sup, ids, inv, 1, block_q=good)
    assert T.check_block_q(None) is None


def test_block_q_without_a_tile_follows_the_batch():
    """No tile asked for: 16 below Q 64, 64 from it."""
    assert [T.block_q_for(Q) for Q in (1, 16, 17, 63, 64, 65, 1024)] == \
        [16, 16, 16, 16, 64, 64, 64]
    assert T.DEFAULT_BLOCK_Q == 16


def test_plain_versions_ignore_the_tiles(ds, X):
    """On the CPU every block_q gives the same bits."""
    r = KNNRouter(k=5, index="ivf", device="cpu").fit(ds)
    pq = KNNRouter(k=5, index="ivfpq", m=4, device="cpu").fit(ds)
    q = r._queries(X)
    base = T.ivf_topk(q, r._ivf, 5)
    for b in T.IVF_BLOCK_QS:
        out = T.ivf_topk(q, r._ivf, 5, block_q=b)
        assert all(torch.equal(a, c) for a, c in zip(base, out))


def _spy(monkeypatch, name):
    """Record the keyword arguments `KNNRouter._search` passes to the
    search ``name`` (imported into `knn.py`)."""
    import repro_torch.core.routers.knn as knn_mod
    seen = []
    real = getattr(knn_mod, name)

    def spy(*a, **kw):
        seen.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(knn_mod, name, spy)
    return seen


def test_policy_block_q_crosses_from_a_reference_artifact(ds, X, tmp_path,
                                                          monkeypatch):
    """A reference `KNNRouter(index="ivf")` artifact with a policy tuned to
    block_q 64 loads in the port and reaches `ivf_topk`; its routes equal
    the untuned router's; a policy with block_q 12 cannot be made."""
    from repro.core.dataset import RoutingDataset as JD
    from repro.core.routers import DispatchPolicy as JPolicy
    from repro.core.routers import KNNRouter as JK
    from repro.core.routers import save_router as jax_save
    from repro_torch.core.routers.artifacts import load_router
    j = JK(k=5, index="ivf").fit(JD(ds.name, ds.embeddings, ds.scores, ds.costs,
                                    ds.model_names))
    j.dispatch_policy = JPolicy(cells={}, tiles={"ivf": {"block_q": 64}})
    jax_save(j, tmp_path / "art")
    m = json.loads((tmp_path / "art" / "manifest.json").read_text())
    assert m["dispatch_policy"]["tiles"] == {"ivf": {"block_q": 64}}
    r = load_router(tmp_path / "art", device="cpu")
    assert r.dispatch_policy.tiles_for("ivf") == {"block_q": 64}
    seen = _spy(monkeypatch, "ivf_topk")
    tuned = r.serve_fused(X, LAM)
    assert seen and all(kw["block_q"] == 64 for kw in seen)
    r.dispatch_policy = None
    plain = r.serve_fused(X, LAM)
    assert seen[-1]["block_q"] is None
    for a, b in zip(tuned, plain):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="block_q"):
        DispatchPolicy(cells={}, tiles={"ivf": {"block_q": 12}})


@pytest.mark.parametrize("bad", [12, 128, 0])
def test_load_router_refuses_a_tile_kernel_4_lacks(ds, tmp_path, bad):
    """An artifact whose policy asks kernel 4 for a tile it has no
    instantiation of is refused when it loads, not on every route."""
    from repro_torch.core.routers.artifacts import load_router, save_router
    r = KNNRouter(k=5, index="ivf", device="cpu").fit(ds)
    r.dispatch_policy = DispatchPolicy(cells={},
                                       tiles={"ivf": {"block_q": 32}})
    save_router(r, tmp_path / "art")
    mp = tmp_path / "art" / "manifest.json"
    m = json.loads(mp.read_text())
    m["dispatch_policy"]["tiles"]["ivf"]["block_q"] = bad
    mp.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="block_q"):
        load_router(tmp_path / "art", device="cpu")


def test_policy_probe_chunk_is_carried_not_used(ds, X, tmp_path,
                                               monkeypatch):
    """A policy's probe_chunk round-trips with the artifact but reaches no
    kernel: `ivfpq_topk` takes no such knob (kernel 5's shape picks its
    path), and the routes equal the untuned router's."""
    from repro_torch.core.routers.artifacts import load_router, save_router
    r = KNNRouter(k=5, index="ivfpq", m=4, device="cpu").fit(ds)
    r.dispatch_policy = DispatchPolicy(
        cells={}, tiles={"ivfpq": {"block_q": 32, "probe_chunk": 2}})
    save_router(r, tmp_path / "art")
    r2 = load_router(tmp_path / "art", device="cpu")
    assert r2.dispatch_policy.tiles_for("ivfpq") == {"block_q": 32,
                                                     "probe_chunk": 2}
    seen = _spy(monkeypatch, "ivfpq_topk")
    a = r2.serve_fused(X, LAM)
    assert seen and all("probe_chunk" not in kw and "block_q" not in kw
                        for kw in seen)
    r2.dispatch_policy = None
    b = r2.serve_fused(X, LAM)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_autotune_ivfpq_times_one_search(ds, monkeypatch):
    """Kernel 5 has no query tile and its shape picks its path: IVF-PQ is
    timed once, every candidate carries that one measurement, and the
    defaults are chosen (the first candidate where the default is not
    among them)."""
    r = KNNRouter(k=5, index="ivfpq", m=4, device="cpu").fit(ds)
    q = np.random.default_rng(5).normal(size=(8, D)).astype(np.float32)
    calls = []
    real = AT._p50
    monkeypatch.setattr(AT, "_p50", lambda *a, **kw: calls.append(1) or
                        real(*a, **kw))
    t = AT.autotune_router(r, q, repeats=1, block_qs=(8, 16, 64),
                           probe_chunks=(0, 2, 4))
    assert len(calls) == 1
    assert (t["block_q"], t["probe_chunk"]) == (16, 0)
    cands = [*t["sweep"]["block_q"].values(),
             *t["sweep"]["probe_chunk"].values()]
    assert len(cands) == 6 and all(c == cands[0] for c in cands)
    t = AT.autotune_router(r, q, repeats=1, block_qs=(32, 64),
                           probe_chunks=(2,))
    assert (t["block_q"], t["probe_chunk"]) == (32, 2)
