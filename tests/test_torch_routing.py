"""Port kNN router (`repro_torch.core.routers`) against the JAX package:
the decision tail (utility, confidence, availability-masked per-request
lambda selection) on the same retrieval results, and the router end to
end on the same support set and queries.  Choices must be equal; s_hat,
c_hat, kth and agreement allclose at 1e-5 (f32 weighted means over k
neighbours: summation order moves them by ~1e-7)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dataset import RoutingDataset as JaxDataset  # noqa: E402
from repro.core.routers import knn as jknn  # noqa: E402
from repro.core.routers import make_router as jax_make_router  # noqa: E402
from repro_torch.core.dataset import RoutingDataset  # noqa: E402
from repro_torch.core.routers import (KNNRouter, format_spec,  # noqa: E402
                                      make_router, parse_spec, router_config,
                                      spec_of)
from repro_torch.core.routers import knn as tknn  # noqa: E402

TOL = 1e-5


def _retrieval(Q=12, k=10, N=300, M=3, seed=0):
    """Sorted sims with a -inf / -1 tail on some rows, like an index that
    could not fill k neighbours."""
    rng = np.random.default_rng(seed)
    sims = -np.sort(-rng.uniform(-1, 1, (Q, k)), axis=1).astype(np.float32)
    idx = rng.integers(0, N, (Q, k)).astype(np.int32)
    n_valid = rng.integers(0, k + 1, Q)
    n_valid[0], n_valid[1] = k, 0            # a full row and an empty row
    for q, n in enumerate(n_valid):
        sims[q, n:] = -np.inf
        idx[q, n:] = -1
    S = rng.uniform(0, 1, (N, M)).astype(np.float32)
    C = rng.uniform(0, 0.01, (N, M)).astype(np.float32)
    return sims, idx, S, C


@pytest.mark.parametrize("weights", ["uniform", "softmax"])
def test_utility_and_confidence_match_reference(weights):
    sims, idx, S, C = _retrieval()
    js, jc = jknn._utility_jit(jnp.asarray(sims), jnp.asarray(idx),
                               jnp.asarray(S), jnp.asarray(C),
                               weights=weights, temperature=20.0)
    ts, tc = tknn._utility(*(torch.from_numpy(a) for a in (sims, idx, S, C)),
                           weights=weights, temperature=20.0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL)
    jk, ja = jknn._confidence_jit(jnp.asarray(sims), jnp.asarray(idx),
                                  jnp.asarray(S))
    tk, ta = tknn._confidence(*(torch.from_numpy(a) for a in (sims, idx, S)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=TOL)


def test_empty_slots_never_average_in_a_real_row():
    """idx == -1 slots carry zero weight: poisoning the row that a clamped
    -1 would alias (row 0) must not move any estimate."""
    sims, idx, S, C = _retrieval()
    S2 = S.copy()
    S2[0] = 100.0
    a = tknn._utility(*(torch.from_numpy(x) for x in (sims, idx, S, C)),
                      weights="uniform", temperature=20.0)[0]
    rows = ~(idx == 0).any(1)
    b = tknn._utility(*(torch.from_numpy(x) for x in (sims, idx, S2, C)),
                      weights="uniform", temperature=20.0)[0]
    np.testing.assert_array_equal(a.numpy()[rows], b.numpy()[rows])
    assert (b.numpy()[1] == 0).all()          # the all-empty row


@pytest.mark.parametrize("avail", [None, [True, False, True],
                                   [False, True, False]])
def test_serve_tail_matches_reference(avail):
    sims, idx, S, C = _retrieval(Q=16, M=3, seed=4)
    lam = np.array([0.0, 0.5, 10.0, 100.0] * 4, np.float32)
    av = np.ones(3, bool) if avail is None else np.array(avail)
    jout = jknn._serve_tail_jit(*(jnp.asarray(a) for a in
                                  (sims, idx, S, C, lam, av)),
                                weights="uniform", temperature=20.0)
    tout = tknn._serve_tail(*(torch.from_numpy(a) for a in
                              (sims, idx, S, C, lam, av)),
                            weights="uniform", temperature=20.0)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for t, j in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)
    if avail is not None:
        assert av[tout[0].numpy()].all()


def _datasets(N=400, D=32, M=3, seed=1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, D)) * 3
    topic = rng.integers(0, 6, N)
    X = (centers[topic] + rng.normal(size=(N, D))).astype(np.float32)
    S = np.clip(rng.uniform(0.2, 1, (6, M))[topic]
                + rng.normal(0, 0.05, (N, M)), 0, 1).astype(np.float32)
    C = np.tile(rng.uniform(0.001, 0.01, M), (N, 1)).astype(np.float32)
    names = [f"m{i}" for i in range(M)]
    Q = (centers[rng.integers(0, 6, 20)]
         + rng.normal(size=(20, D))).astype(np.float32)
    return (JaxDataset("d", X, S, C, names), RoutingDataset("d", X, S, C,
                                                            names), Q)


@pytest.mark.parametrize("k,weights", [(10, "uniform"), (100, "softmax")])
def test_router_serve_fused_matches_reference(k, weights):
    jds, tds, Q = _datasets()
    jr = jax_make_router(f"knn{k}", weights=weights).fit(jds)
    tr = make_router(f"knn{k}", weights=weights, device="cpu").fit(tds)
    lam = np.linspace(0, 50, len(Q)).astype(np.float32)
    for avail in (None, np.array([True, False, True])):
        jo = jr.serve_fused(Q, lam, avail=avail)
        to = tr.serve_fused(Q, lam, avail=avail)
        np.testing.assert_array_equal(to[0], jo[0])
        for t, j in zip(to[1:], jo[1:]):
            np.testing.assert_allclose(t, j, atol=TOL)
    # the staged calls give the same numbers as the fused path
    s_hat, c_hat, kth, agree = tr.predict_with_confidence(Q)
    np.testing.assert_allclose(s_hat, to[1], atol=TOL)
    np.testing.assert_allclose(agree, to[4], atol=TOL)
    np.testing.assert_allclose(tr.predict_utility(Q)[0], s_hat, atol=TOL)
    np.testing.assert_allclose(tr.confidence(Q)[0], kth, atol=TOL)
    jk, _ = jr.confidence(Q)
    np.testing.assert_allclose(kth, jk, atol=TOL)


@pytest.mark.parametrize("spec", ["knn200", "knn200@lam=0.5"])
def test_router_k_above_128_matches_reference(spec):
    """Exact retrieval with k = 200 (above the warp-selection kernel's 128;
    the keyed path serves it on the card): the same choices and utilities
    as the reference."""
    jds, tds, Q = _datasets(N=600)
    jr = jax_make_router(spec).fit(jds)
    tr = make_router(spec, device="cpu").fit(tds)
    assert tr.k == jr.k == 200
    lam = np.linspace(0, 50, len(Q)).astype(np.float32)
    jo, to = jr.serve_fused(Q, lam), tr.serve_fused(Q, lam)
    np.testing.assert_array_equal(to[0], jo[0])
    for t, j in zip(to[1:], jo[1:]):
        np.testing.assert_allclose(t, j, atol=TOL)
    np.testing.assert_allclose(tr.predict_utility(Q)[0],
                               jr.predict_utility(Q)[0], atol=TOL)


@pytest.mark.parametrize("spec", ["knn1100", "knn1100-ivf@nprobe=64",
                                  "knn1100-ivfpq@m=8,nprobe=64,rerank=2"])
def test_router_k_above_1024_matches_reference(spec):
    """k = 1,100, above one round of the card's selection pass (1,024), on
    all three indexes: the same choices and utilities as the reference."""
    jds, tds, Q = _datasets(N=2000)
    jr = jax_make_router(spec).fit(jds)
    tr = make_router(spec, device="cpu").fit(tds)
    assert tr.k == jr.k == 1100
    assert tr._neighbors(Q)[1].shape == (len(Q), 1100)
    lam = np.linspace(0, 50, len(Q)).astype(np.float32)
    jo, to = jr.serve_fused(Q, lam), tr.serve_fused(Q, lam)
    np.testing.assert_array_equal(to[0], jo[0])
    for t, j in zip(to[1:], jo[1:]):
        np.testing.assert_allclose(t, np.asarray(j), atol=TOL)


def test_router_k_above_support_clamps_like_reference():
    jds, tds, Q = _datasets(N=40)
    jr = jax_make_router("knn100").fit(jds)
    tr = make_router("knn100", device="cpu").fit(tds)
    js, jc = jr.predict_utility(Q)
    ts, tc = tr.predict_utility(Q)
    np.testing.assert_allclose(ts, js, atol=TOL)
    assert tr._neighbors(Q)[1].shape == (len(Q), 28)      # 70% train split


def test_spec_grammar_and_router_construction():
    r = make_router("knn10@lam=0.5,weights=softmax", device="cpu")
    assert isinstance(r, KNNRouter) and r.k == 10 and r.default_lam == 0.5
    assert r.weights == "softmax" and spec_of(r) == "knn10"
    assert parse_spec("knn100").k == 100
    for bad in ("knn10-ivfp", "mlp", "knn10@nope=1", "knn10@", "knn-pq"):
        with pytest.raises(ValueError):
            make_router(bad)
    with pytest.raises(ValueError, match="index"):
        KNNRouter(index="hnsw")
    with pytest.raises(ValueError, match="backend"):
        KNNRouter(index="ivf", backend="gpu")


@pytest.mark.parametrize("spec,index", [
    ("knn100-ivf", "ivf"), ("knn100-ivfpq", "ivfpq"),
    ("knn100-ivfpq@m=16,nbits=4,rerank=4", "ivfpq"),
    ("knn10-ivf@lam=0.5,nprobe=4", "ivf"), ("knn10_ivf", "ivf"),
    ("knn10_ivfpq@backend=pallas,use_pallas=true", "ivfpq")])
def test_ivf_spec_grammar_round_trips_like_reference(spec, index):
    from repro.core.routers.spec import format_spec as jax_format
    from repro.core.routers.spec import parse_spec as jax_parse
    from repro.core.routers.spec import router_config as jax_config
    from repro.core.routers.spec import spec_of as jax_spec_of
    ps, js = parse_spec(spec), jax_parse(spec)
    assert (ps.family, ps.k, ps.ivf, ps.pq, dict(ps.kwargs)) == (
        js.family, js.k, js.ivf, js.pq, dict(js.kwargs))
    assert format_spec(ps) == jax_format(js)
    assert parse_spec(format_spec(ps)) == ps
    r, jr = make_router(spec, device="cpu"), jax_make_router(spec)
    assert r.index == index == jr.index
    assert spec_of(r) == jax_spec_of(jr)
    assert router_config(r) == jax_config(jr)
    # the config rebuilds the same router in both packages
    assert router_config(KNNRouter(**router_config(jr), device="cpu")) \
        == router_config(r)


def test_availability_mask_validation():
    _, tds, Q = _datasets()
    tr = make_router("knn10", device="cpu").fit(tds)
    with pytest.raises(ValueError, match="every model"):
        tr.serve_fused(Q, np.zeros(len(Q), np.float32),
                       avail=np.zeros(3, bool))
    with pytest.raises(ValueError, match="shape"):
        tr.serve_fused(Q, np.zeros(len(Q), np.float32),
                       avail=np.ones(2, bool))


@pytest.mark.parametrize("spec", ["knn20-ivf", "knn20-ivf@nprobe=2",
                                  "knn20-ivfpq@m=8",
                                  "knn20-ivfpq@m=8,nbits=4,rerank=0"])
def test_ivf_router_serve_fused_matches_reference(spec):
    jds, tds, Q = _datasets(N=900)
    jr = jax_make_router(spec).fit(jds)
    tr = make_router(spec, device="cpu").fit(tds)
    np.testing.assert_array_equal(tr._X, jr._X)
    lam = np.linspace(0, 50, len(Q)).astype(np.float32)
    jo = jr.serve_fused(Q, lam)
    to = tr.serve_fused(Q, lam)
    np.testing.assert_array_equal(to[0], jo[0])
    for t, j in zip(to[1:], jo[1:]):
        np.testing.assert_allclose(t, np.asarray(j), atol=TOL)
    s_hat, _, kth, _ = tr.predict_with_confidence(Q)
    np.testing.assert_allclose(s_hat, to[1], atol=TOL)
    np.testing.assert_allclose(kth, to[3], atol=TOL)


def test_ivf_router_k_above_candidates_clamps_like_reference():
    """k above the rows a query's probed lists hold clamps to
    ``nprobe * L`` exactly as the reference's router does."""
    jds, tds, Q = _datasets(N=200)
    jr = jax_make_router("knn100-ivfpq@nprobe=1,m=8").fit(jds)
    tr = make_router("knn100-ivfpq@nprobe=1,m=8", device="cpu").fit(tds)
    L = tr._ivf.list_size
    assert L < 100
    assert tr._neighbors(Q)[1].shape == jr._neighbors(Q)[1].shape == (
        len(Q), L)
    np.testing.assert_allclose(tr.predict_utility(Q)[0],
                               jr.predict_utility(Q)[0], atol=TOL)
