"""The port's streaming tier (`repro_torch.kernels.knn_ivf.ops.
DynamicIVFIndex`, `KNNRouter.partial_fit`) against the JAX package on the
CPU, on the same numpy-seeded inputs (the port of `tests/test_online.py`).

The numpy builds, the appends' centroid assignments and a compaction give
the reference's bytes.  Searches compare the same backend in both packages
— with a delta tier ``"fused"`` probes the delta sub-lists and the staged
backends scan the whole tier, so the backend picks the neighbours.
Tolerances are those of `tests/test_torch_ivf.py`: 1e-5 for IVF scores,
rtol 1e-4 / atol 1e-5 for ADC scores, ids equal except where two
candidates tie within the tolerance; predictions at 1e-5."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dataset import RoutingDataset as JaxDataset  # noqa: E402
from repro.core.routers import make_router as jax_make  # noqa: E402
from repro.kernels.knn_ivf import ops as J  # noqa: E402
from repro_torch.core.dataset import RoutingDataset  # noqa: E402
from repro_torch.core.routers import make_router  # noqa: E402
from repro_torch.core.routers.knn import KNNRouter  # noqa: E402
from repro_torch.kernels.knn_ivf import ops as T  # noqa: E402
from repro_torch.kernels.knn_ivf.ref import (ivf_probe, ivf_scan_plain,  # noqa: E402
                                             ivfpq_adc_plain)
from repro_torch.kernels.knn_topk.ref import knn_topk_reference  # noqa: E402

D = 16
IVF_TOL = 1e-5
ADC_RTOL, ADC_ATOL = 1e-4, 1e-5
PRED_TOL = 1e-5


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    sup = rng.normal(size=(600, D)).astype(np.float32)
    extra = rng.normal(size=(80, D)).astype(np.float32)
    q = rng.normal(size=(12, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return sup, extra, q


def _same_up_to_ties(ts, ti, js, ji, atol, rtol=0.0):
    ts, ti = np.asarray(ts), np.asarray(ti)
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=atol)
    assert np.array_equal(ti < 0, ji < 0)
    for r, c in zip(*np.nonzero(ti != ji)):
        near = np.abs(js[r] - ts[r, c]) <= atol + rtol * abs(ts[r, c])
        assert ti[r, c] in ji[r][near], (r, c, ti[r, c])


def _pair(kind, sup, seed=0, **kw):
    """(reference, port) dynamic indexes over the same build."""
    if kind == "ivf":
        jb, tb = (J.build_ivf_index(sup, seed=seed),
                  T.build_ivf_index(sup, seed=seed, device="cpu"))
        bk = {"seed": seed}
    else:
        nbits = kw.get("nbits", 8)
        jb = J.build_ivfpq_index(sup, m=4, nbits=nbits, seed=seed)
        tb = T.build_ivfpq_index(sup, m=4, nbits=nbits, seed=seed,
                                 device="cpu")
        bk = {"m": 4, "nbits": nbits, "seed": seed}
    cap = kw.get("delta_cap", 4096)
    return (J.DynamicIVFIndex(jb, delta_cap=cap, build_kw=bk),
            T.DynamicIVFIndex(tb, delta_cap=cap, build_kw=bk))


# ---------------------------------------------------------------------------
# builds, appends, compaction: the reference's bytes
# ---------------------------------------------------------------------------

def test_index_builds_are_seed_deterministic(corpus):
    """Two port builds from one seed agree bitwise, and equal the
    reference's bytes (centroids, lists, PQ codebooks and codes)."""
    sup, _, _ = corpus
    a, b = (T.build_ivf_index(sup, seed=7, device="cpu") for _ in range(2))
    j = J.build_ivf_index(sup, seed=7)
    for x in (b, j):
        np.testing.assert_array_equal(a.centroids_h, np.asarray(x.centroids))
        np.testing.assert_array_equal(a.ids_h, x.ids_h)
        np.testing.assert_array_equal(a.sup_h, x.sup_h)
    pa, pb = (T.build_ivfpq_index(sup, m=4, seed=7, device="cpu")
              for _ in range(2))
    pj = J.build_ivfpq_index(sup, m=4, seed=7)
    for x in (pb, pj):
        np.testing.assert_array_equal(pa.codebooks_h, x.codebooks_h)
        np.testing.assert_array_equal(pa.codes_h, x.codes_h)
        np.testing.assert_array_equal(pa.ids_h, x.ids_h)


def test_append_assigns_ids_and_counters(corpus):
    sup, extra, _ = corpus
    jd, dyn = _pair("ivf", sup, delta_cap=500)
    ids = dyn.append(extra[:30])
    np.testing.assert_array_equal(ids, 600 + np.arange(30))
    ids2 = dyn.append(extra[30:])
    np.testing.assert_array_equal(ids2, 630 + np.arange(50))
    assert dyn.n_rows == 680 and dyn.delta_rows == 80 and dyn.appends == 80
    jd.append(extra[:30])
    jd.append(extra[30:])
    np.testing.assert_array_equal(dyn.delta_assign, jd.delta_assign)
    occ = dyn.delta_occupancy()
    assert occ.shape == (dyn.n_clusters,) and occ.sum() == 80
    np.testing.assert_array_equal(occ, jd.delta_occupancy())
    assert not dyn.needs_recluster and not dyn.maybe_recluster()
    # the device tier: rows in append order, grouped by centroid
    snap = dyn.fused_state()
    d = snap.delta
    assert snap.n_rows == 680 and d.n_base == 600
    assert d.lmax == occ.max() and snap.lc == T._pow2_pad(occ.max())
    np.testing.assert_array_equal(d.rows.numpy(), dyn.delta_x)
    np.testing.assert_array_equal(np.diff(d.off.numpy()), occ)
    assert (np.diff(dyn.delta_assign[d.perm.numpy()]) >= 0).all()


@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
@pytest.mark.parametrize("backend", ["fused", "host"])
def test_appended_rows_are_immediately_retrievable(corpus, kind, backend):
    """A query equal to a freshly appended row retrieves it first, with
    the exact cosine 1.0, on either semantics; and the port's result equals
    the reference's on the same backend."""
    sup, extra, _ = corpus
    jd, dyn = _pair(kind, sup)
    ids = dyn.append(extra)
    jd.append(extra)
    q = extra[:4] / np.linalg.norm(extra[:4], axis=1, keepdims=True)
    top = T.ivfpq_topk if kind == "ivfpq" else T.ivf_topk
    jtop = J.ivfpq_topk if kind == "ivfpq" else J.ivf_topk
    sc, ix = top(q, dyn, 5, backend=backend)
    for i in range(4):
        assert ids[i] in ix[i].numpy(), (ids[i], ix[i])
    np.testing.assert_allclose(sc[:, 0].numpy(), 1.0, rtol=1e-5)
    js, ji = jtop(jnp.asarray(q), jd, 5, backend=backend)
    _same_up_to_ties(sc, ix, js, ji, IVF_TOL)


def test_full_probe_dynamic_equals_bruteforce(corpus):
    """nprobe == C plus the exact delta scan is the brute-force result over
    base + delta."""
    sup, extra, q = corpus
    full = torch.from_numpy(np.concatenate([sup, extra]))
    es, _ = knn_topk_reference(torch.from_numpy(q), full, 15)
    _, dyn = _pair("ivf", sup)
    dyn.append(extra)
    for backend in ("host", "fused"):
        sc, _ = T.ivf_topk(q, dyn, 15, nprobe=dyn.n_clusters,
                           backend=backend)
        np.testing.assert_allclose(sc.numpy(), es.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
def test_recluster_matches_fresh_build_bitwise(corpus, kind):
    """A compaction equals a fresh build over the same rows, byte for byte,
    in the port and against the reference's compaction."""
    sup, extra, _ = corpus
    jd, dyn = _pair(kind, sup, seed=5)
    dyn.append(extra)
    jd.append(extra)
    dyn.recluster()
    jd.recluster()
    rows = np.concatenate([sup, extra])
    if kind == "ivf":
        fresh = T.build_ivf_index(rows, seed=5, device="cpu")
        fields = ("centroids_h", "sup_h", "ids_h", "inv_h")
    else:
        fresh = T.build_ivfpq_index(rows, m=4, seed=5, device="cpu")
        fields = ("centroids_h", "codes_h", "ids_h", "inv_h", "codebooks_h",
                  "anchors_h")
    for f in fields:
        np.testing.assert_array_equal(getattr(dyn.base, f),
                                      getattr(fresh, f))
        jf = (np.asarray(jd.base.centroids) if f == "centroids_h"
              else getattr(jd.base, f))
        np.testing.assert_array_equal(getattr(dyn.base, f), jf)
    assert dyn.delta_rows == 0 and dyn.reclusters == 1 and dyn.n_rows == 680
    assert dyn.fused_state().delta is None


def test_delta_cap_validation_and_type_guard(corpus):
    sup, _, _ = corpus
    with pytest.raises(TypeError):
        T.DynamicIVFIndex(sup)
    with pytest.raises(ValueError):
        T.DynamicIVFIndex(T.build_ivf_index(sup, seed=0, device="cpu"),
                          delta_cap=0)
    dyn = T.DynamicIVFIndex(T.build_ivf_index(sup, seed=0, device="cpu"))
    with pytest.raises(ValueError):
        dyn.append(np.zeros((3, D + 1), np.float32))


# ---------------------------------------------------------------------------
# the plain delta versions and the staged merge against the reference
# ---------------------------------------------------------------------------

def _skewed(sup, extra, kind, nbits=8):
    """A tier with rows in several lists and one list holding most."""
    jd, dyn = _pair(kind, sup, nbits=nbits)
    hot = extra[:1] * 0.9 + 0.05 * np.random.default_rng(0).normal(
        size=(40, D)).astype(np.float32)
    for rows in (extra, hot):
        dyn.append(rows)
        jd.append(rows)
    return jd, dyn


def test_plain_delta_ivf_matches_reference_fused_dyn(corpus):
    """`ivf_scan_plain` with the delta tier against
    `_fused_dyn_ivf_topk_impl` over the reference's padded sub-lists."""
    sup, extra, q = corpus
    jd, dyn = _skewed(sup, extra, "ivf")
    st = jd.fused_state()
    b = jd.base
    for nprobe, k in ((3, 20), (b.n_clusters, 60)):
        js, ji = J._fused_dyn_ivf_topk_impl(
            jnp.asarray(q), b.centroids, b.sup_cm, b.ids_cm, b.inv_cm,
            st["dl_sup"], st["dl_ids"], st["dl_inv"], k=k, nprobe=nprobe)
        snap = dyn.fused_state()
        tq = torch.from_numpy(q)
        probe = ivf_probe(tq, snap.base.centroids, nprobe)
        ts, ti = ivf_scan_plain(tq, probe, snap.base.sup_cm,
                                snap.base.ids_cm, snap.base.inv_cm, k,
                                snap.delta)
        _same_up_to_ties(ts, ti, js, ji, IVF_TOL)


@pytest.mark.parametrize("nbits", [8, 4])
def test_plain_delta_adc_matches_reference_fused_dyn(corpus, nbits):
    """`ivfpq_adc_plain` with the delta tier (codes against their own
    centroid's anchor) against `_fused_dyn_ivfpq_topk_impl` at kk = 0 (the
    raw ADC top-k), and the port's fused two-stage search against the
    reference's at kk = 8 k."""
    sup, extra, q = corpus
    jd, dyn = _skewed(sup, extra, "ivfpq", nbits=nbits)
    st = jd.fused_state()
    b = jd.base
    js, ji = J._fused_dyn_ivfpq_topk_impl(
        jnp.asarray(q), b.centroids, b.codes_rm, b.ids_cm, b.inv_cm,
        b.anchors, b.codebooks, st["dl_codes"], st["dl_ids"], st["dl_inv"],
        st["sup_all"], st["inv_all"], k=30, kk=0, nprobe=3, m=b.m,
        nbits=b.nbits)
    snap = dyn.fused_state()
    tb = snap.base
    tq = torch.from_numpy(q)
    probe = ivf_probe(tq, tb.centroids, 3)
    ts, ti = ivfpq_adc_plain(tq, probe, tb.codes_cm, tb.ids_cm, tb.inv_cm,
                             tb.anchors, tb.codebooks, 30, tb.m, tb.nbits,
                             snap.delta)
    _same_up_to_ties(ts, ti, js, ji, ADC_ATOL, ADC_RTOL)
    js, ji = J.ivfpq_topk(jnp.asarray(q), jd, 10, nprobe=3, backend="fused")
    ts, ti = T.ivfpq_topk(q, dyn, 10, nprobe=3, backend="fused")
    _same_up_to_ties(ts, ti, js, ji, IVF_TOL)


@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
def test_staged_merge_matches_reference_merge_delta(corpus, kind):
    """The staged backends' merge (kernel 1 over the tier, a stable sort
    with base candidates first) against the reference's `merge_delta` on
    the same base result, and the whole staged search against the
    reference's ``host`` backend.  With an empty tier the base result
    passes through."""
    sup, extra, q = corpus
    jd, dyn = _pair(kind, sup)
    top = T.ivfpq_topk if kind == "ivfpq" else T.ivf_topk
    jtop = J.ivfpq_topk if kind == "ivfpq" else J.ivf_topk
    bs, bi = top(q, dyn.base, 10, nprobe=2)
    out = dyn.merge_delta(q, bs, bi, 10)
    assert out[0] is bs and out[1] is bi
    dyn.append(extra)
    jd.append(extra)
    ts, ti = dyn.merge_delta(q, bs, bi, 10)
    js, ji = jd.merge_delta(jnp.asarray(q), bs.numpy(), bi.numpy(), 10)
    _same_up_to_ties(ts, ti, js, ji, IVF_TOL)
    ds, di = dyn.delta_topk(q, 10)
    jds, jdi = jd.delta_topk(q, 10)
    _same_up_to_ties(ds, di, jds, jdi, IVF_TOL)
    _same_up_to_ties(*top(q, dyn, 10, nprobe=2, backend="host"),
                     *jtop(jnp.asarray(q), jd, 10, nprobe=2,
                           backend="host"), IVF_TOL)


# ---------------------------------------------------------------------------
# KNNRouter.partial_fit, against the reference on the same backend
# ---------------------------------------------------------------------------

def _ds(n=80, m_models=3, seed=0, d=D):
    rng = np.random.default_rng(seed)
    args = ("online", rng.normal(size=(n, d)).astype(np.float32),
            rng.uniform(0.2, 1.0, (n, m_models)).astype(np.float32),
            rng.uniform(0.001, 0.01, (n, m_models)).astype(np.float32),
            [f"m{i}" for i in range(m_models)])
    return JaxDataset(*args), RoutingDataset(*args)


@pytest.mark.parametrize("index", ["exact", "ivf", "ivfpq"])
def test_partial_fit_updates_predictions(index):
    """A novel embedding observed with an extreme score dominates its own
    prediction afterwards (k=1 retrieves the new row)."""
    _, ds = _ds()
    r = KNNRouter(k=1, index=index, online=True, device="cpu").fit(ds)
    base = r.support_size
    novel = np.full((1, D), 5.0, np.float32)
    r.partial_fit(novel, np.array([[0.9, 0.1, 0.1]], np.float32),
                  np.array([[0.5, 0.5, 0.5]], np.float32))
    assert r.support_size == base + 1
    s, c = r.predict_utility(novel)
    np.testing.assert_allclose(s[0], [0.9, 0.1, 0.1], atol=1e-6)
    np.testing.assert_allclose(c[0], [0.5, 0.5, 0.5], atol=1e-6)


@pytest.mark.parametrize("spec,backend", [
    ("knn5", None), ("knn5-ivf", "host"), ("knn5-ivf", "fused"),
    ("knn5-ivfpq@m=4", "fused"), ("knn5-ivfpq@m=4", "host")])
def test_partial_fit_predictions_match_reference(spec, backend):
    """The same fit and the same observed batches (one compaction on the
    way, then a pending tier) in both packages: equal choices and
    utilities at 1e-5, on the same backend, through ``serve_fused``."""
    jds, ds = _ds(n=300, seed=2)
    kw = {"delta_cap": 40} | ({"backend": backend} if backend else {})
    jr = jax_make(spec, **kw).fit(jds)
    tr = make_router(spec, device="cpu", **kw).fit(ds)
    rng = np.random.default_rng(5)
    for n in (30, 30, 20):
        X = rng.normal(size=(n, D)).astype(np.float32)
        S = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        jr.partial_fit(X, S)
        tr.partial_fit(X, S)
    assert tr.support_size == jr.support_size
    if spec != "knn5":
        assert (tr._ivf.reclusters, tr._ivf.delta_rows) == (
            jr._ivf.reclusters, jr._ivf.delta_rows) == (1, 20)
    Q = np.concatenate([X[:6], rng.normal(size=(10, D)).astype(np.float32)])
    lam = np.linspace(0, 30, 16).astype(np.float32)
    j = jr.serve_fused(Q, lam)
    t = tr.serve_fused(Q, lam)
    np.testing.assert_array_equal(t[0], j[0])
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_allclose(a, b, atol=PRED_TOL)


def test_partial_fit_lazy_wrap_and_auto_recluster():
    _, ds = _ds()
    r = KNNRouter(k=3, index="ivf", delta_cap=10, device="cpu").fit(ds)
    assert not isinstance(r._ivf, T.DynamicIVFIndex)
    rng = np.random.default_rng(1)
    r.partial_fit(rng.normal(size=(6, D)).astype(np.float32),
                  rng.uniform(0, 1, (6, 3)).astype(np.float32))
    assert isinstance(r._ivf, T.DynamicIVFIndex)
    assert r._ivf.delta_rows == 6
    r.partial_fit(rng.normal(size=(6, D)).astype(np.float32),
                  rng.uniform(0, 1, (6, 3)).astype(np.float32))
    assert r._ivf.delta_rows == 0 and r._ivf.reclusters == 1
    assert r._ivf.base.n_rows == r.support_size == len(ds.train_idx) + 12


def test_partial_fit_validation():
    _, ds = _ds()
    with pytest.raises(RuntimeError, match="before fit"):
        KNNRouter(k=3, device="cpu").partial_fit(np.zeros((1, D)),
                                                 np.zeros((1, 3)))
    r = KNNRouter(k=3, device="cpu").fit(ds)
    with pytest.raises(ValueError, match="scores"):
        r.partial_fit(np.zeros((2, D)), np.zeros((2, 2)))
    with pytest.raises(ValueError, match="costs"):
        r.partial_fit(np.zeros((2, D)), np.zeros((2, 3)), np.zeros((1, 3)))


def test_spec_grammar_online_keys():
    r = make_router("knn5-ivf@online=1,delta_cap=64", device="cpu")
    assert r.online and r.delta_cap == 64 and r.index == "ivf"
    r.fit(_ds()[1])
    assert isinstance(r._ivf, T.DynamicIVFIndex)
    assert r._ivf.delta_cap == 64


def test_degrade_3_skips_the_delta():
    """Ladder level 3 (``skip_delta``) serves the base only: observed rows
    are not retrieved, and the choices equal the reference's at level 3."""
    from repro.serving.router_service import RouterService as JaxService
    from repro_torch.serving.encoder import QueryEncoder
    from repro_torch.serving.router_service import RouterService
    jds, ds = _ds(n=300, seed=3)
    names = ds.model_names
    spec = "knn5-ivf@online=1,backend=fused"
    js = JaxService(jax_make(spec).fit(jds), {m: None for m in names})
    ts = RouterService(make_router(spec, device="cpu").fit(ds),
                       {m: None for m in names},
                       encoder=QueryEncoder(device="cpu"))
    rng = np.random.default_rng(6)
    X = rng.normal(size=(20, D)).astype(np.float32)
    S = np.full((20, 3), 0.1, np.float32)
    S[:, 2] = 5.0
    js.observe(X, S, recluster=False)
    ts.observe(X, S, recluster=False)
    n_base = ts.router._ivf.base.n_rows
    lam = np.zeros(20, np.float32)
    with ts.router.degraded(ts.ladder[3]):
        _, idx = ts.router._neighbors(X, "fused")
    assert (idx < n_base).all()
    full = ts.route_fused(X, lam)
    assert (full[0] == 2).all()                 # the observed rows win
    t = ts.route_fused(X, lam, degrade=3)
    j = js.route_fused(X, lam, degrade=3)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], atol=PRED_TOL)
    assert not ts.router._skip_delta


@pytest.mark.parametrize("spec", ["knn5-ivf", "knn5-ivfpq@m=4"])
def test_routes_while_another_thread_observes_and_compacts(spec,
                                                           monkeypatch):
    """Routes on one thread while another observes past ``delta_cap`` with
    background compaction: no route fails or returns an id its support does
    not cover, a route lands during the rebuild (the rebuild waits for
    one), and after the join the base equals a fresh build over
    ``all_rows()`` byte for byte."""
    _, ds = _ds(n=600, seed=4)
    r = make_router(spec, device="cpu", delta_cap=60).fit(ds)
    Q = np.random.default_rng(7).normal(size=(8, D)).astype(np.float32)
    lam = np.zeros(8, np.float32)
    in_build, routed = threading.Event(), threading.Event()
    build = T.DynamicIVFIndex._build_base

    def held_build(self, rows):
        in_build.set()
        routed.wait(60)
        return build(self, rows)

    monkeypatch.setattr(T.DynamicIVFIndex, "_build_base", held_build)
    stop, errors, during = threading.Event(), [], [0]

    def routes():
        while not stop.is_set():
            try:
                started = in_build.is_set() and r._ivf.recluster_pending
                out = r.serve_fused(Q, lam)
                assert np.isfinite(out[1]).all()
                _, idx = r._neighbors(Q)
                assert idx.max() < r.support_size
                if started and r._ivf.recluster_pending:
                    during[0] += 1
                    routed.set()
            except Exception as exc:          # noqa: BLE001
                errors.append(exc)
                routed.set()
                return

    t = threading.Thread(target=routes)
    t.start()
    rng = np.random.default_rng(8)
    for _ in range(8):
        r.partial_fit(rng.normal(size=(25, D)).astype(np.float32),
                      rng.uniform(0, 1, (25, 3)).astype(np.float32),
                      recluster="background")
    r.join_recluster()
    stop.set()
    t.join()
    monkeypatch.undo()
    assert not errors, errors
    assert r._ivf.reclusters >= 1 and during[0] >= 1
    r._ivf.recluster()
    dyn = r._ivf
    build = T.build_ivfpq_index if dyn.is_pq else T.build_ivf_index
    fresh = build(dyn.all_rows(), device="cpu", **dyn.build_kw)
    for f in ("centroids_h", "ids_h", "inv_h",
              "codes_h" if dyn.is_pq else "sup_h"):
        np.testing.assert_array_equal(getattr(dyn.base, f),
                                      getattr(fresh, f))
    assert r.support_size == len(ds.train_idx) + 200
