"""Port IVF / IVF-PQ retrieval (`repro_torch.kernels.knn_ivf`) against the
JAX package on the CPU, on the same numpy-seeded inputs: the numpy index
builds give the same bytes; the plain versions of kernel 4 (IVF scan) and
kernel 5 (ADC shortlist) match the Pallas kernels run in interpret mode and
the JAX oracles; the two-stage search matches the reference's fused
backend.  Tolerances are the reference tests': 1e-5 for IVF scores
(`tests/test_ivf.py`), rtol 1e-4 / atol 1e-5 for ADC scores
(`tests/test_ivfpq.py`); ids must be equal except where two candidates'
scores tie within the tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.knn_ivf import ops as J  # noqa: E402
from repro.kernels.knn_ivf import pq as jpq  # noqa: E402
from repro.kernels.knn_ivf.ref import ivf_topk_reference as j_ivf_ref  # noqa: E402
from repro.kernels.knn_ivf.ref import ivfpq_adc_reference as j_adc_ref  # noqa: E402
from repro_torch.kernels.knn_ivf import ops as T  # noqa: E402
from repro_torch.kernels.knn_ivf import pq as tpq  # noqa: E402
from repro_torch.kernels.knn_ivf import ref as R  # noqa: E402
from repro_torch.kernels.knn_topk.ops import knn_topk  # noqa: E402

IVF_TOL = 1e-5
ADC_RTOL, ADC_ATOL = 1e-4, 1e-5
K = 20


def _clustered(N=3000, D=64, Q=40, seed=7):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, D)) * 3.0
    s = (centers[rng.integers(0, 12, N)]
         + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 12, Q)]
         + rng.normal(size=(Q, D))).astype(np.float32)
    return s, q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    return _clustered()


@pytest.fixture(scope="module")
def ivf(data):
    s, _ = data
    return (J.build_ivf_index(s, 16, seed=0),
            T.build_ivf_index(s, 16, seed=0, device="cpu"))


@pytest.fixture(scope="module", params=[8, 4])
def ivfpq(request, data):
    s, _ = data
    nbits = request.param
    return (J.build_ivfpq_index(s, 16, m=8, nbits=nbits, seed=0),
            T.build_ivfpq_index(s, 16, m=8, nbits=nbits, seed=0,
                                device="cpu"))


def _same_up_to_ties(ts, ti, js, ji, atol, rtol=0.0):
    """Scores allclose; an id may differ only where its score ties (within
    the tolerance) with the reference's score in the same slot."""
    ts, ti = np.asarray(ts), np.asarray(ti)
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=atol)
    assert np.array_equal(ti < 0, ji < 0)
    for r, c in zip(*np.nonzero(ti != ji)):
        near = np.abs(js[r] - ts[r, c]) <= atol + rtol * abs(ts[r, c])
        assert ti[r, c] in ji[r][near], (r, c, ti[r, c])


# ---------------------------------------------------------------------------
# index build: the same bytes as the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane_pad", [8, 128])
def test_ivf_build_is_byte_identical_to_reference(data, lane_pad):
    s, _ = data
    j = J.build_ivf_index(s[:1200], 12, seed=3, lane_pad=lane_pad)
    t = T.build_ivf_index(s[:1200], 12, seed=3, lane_pad=lane_pad,
                          device="cpu")
    assert t.list_size % lane_pad == 0 and t.n_rows == j.n_rows
    for a, b in ((np.asarray(j.centroids), t.centroids_h), (j.sup_h, t.sup_h),
                 (j.ids_h, t.ids_h), (j.inv_h, t.inv_h)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(t.centroids.numpy(), t.centroids_h)
    np.testing.assert_array_equal(t.rows(), j.rows())


@pytest.mark.parametrize("lane_pad,nbits", [(8, 8), (8, 4), (128, 8)])
def test_ivfpq_build_is_byte_identical_to_reference(data, lane_pad, nbits):
    s, _ = data
    j = J.build_ivfpq_index(s[:1200], 12, m=8, nbits=nbits, seed=3,
                            lane_pad=lane_pad)
    t = T.build_ivfpq_index(s[:1200], 12, m=8, nbits=nbits, seed=3,
                            lane_pad=lane_pad, device="cpu")
    assert (t.m, t.nbits, t.n_rows) == (j.m, j.nbits, j.n_rows)
    for a, b in ((np.asarray(j.centroids), t.centroids_h),
                 (j.anchors_h, t.anchors_h), (j.codes_h, t.codes_h),
                 (j.ids_h, t.ids_h), (j.inv_h, t.inv_h),
                 (j.codebooks_h, t.codebooks_h),
                 (j.sup_flat_h, t.sup_flat_h)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(t.inv_flat.numpy(), np.asarray(j.inv_flat))


@pytest.mark.parametrize("nbits", [4, 8])
def test_pq_unpack_matches_reference(nbits):
    rng = np.random.default_rng(nbits)
    codes = rng.integers(0, 2 ** nbits, size=(3, 40, 8)).astype(np.uint8)
    packed_cm = np.ascontiguousarray(
        jpq.pack_codes(codes, nbits).transpose(0, 2, 1))     # (C, MB, L)
    got = tpq.unpack_codes_cm(torch.from_numpy(packed_cm), 8, nbits)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpq.unpack_codes_jnp_cm(
            jnp.asarray(packed_cm), 8, nbits)))
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 1), codes)


def test_pq_numpy_helpers_match_reference():
    """The copied numpy helpers give the reference's numbers, and the
    port's torch ADC table equals the numpy one (the ADC identity: a LUT
    gather sum equals the dot against the decoded residual)."""
    assert [tpq.effective_m(48, m) for m in (10, 16, 5)] == \
        [jpq.effective_m(48, m) for m in (10, 16, 5)]
    assert tpq.default_m(768) == jpq.default_m(768) == 64
    rng = np.random.default_rng(3)
    r = rng.normal(size=(300, 32)).astype(np.float32)
    cb = tpq.train_pq(r, m=4, nbits=4, seed=1)
    np.testing.assert_array_equal(cb, jpq.train_pq(r, m=4, nbits=4, seed=1))
    codes = tpq.encode_pq(r, cb)
    np.testing.assert_array_equal(codes, jpq.encode_pq(r, cb))
    np.testing.assert_array_equal(tpq.decode_pq(codes, cb),
                                  jpq.decode_pq(codes, cb))
    np.testing.assert_array_equal(tpq.expand_codebooks(cb),
                                  jpq.expand_codebooks(cb))
    q = r[:5]
    lut = tpq.adc_lut(q, cb)
    np.testing.assert_allclose(
        R.adc_table(torch.from_numpy(q), torch.from_numpy(cb)).numpy(), lut,
        rtol=1e-5, atol=1e-6)
    gathered = np.take_along_axis(lut, codes[:5, :, None].astype(np.int64),
                                  axis=2)[..., 0].sum(1)
    np.testing.assert_allclose(
        gathered, np.einsum("qd,qd->q", q, tpq.decode_pq(codes[:5], cb)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# kernel 4: the IVF scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nprobe", [1, 4, 8])
def test_ivf_scan_plain_matches_pallas_and_reference(data, ivf, nprobe):
    _, q = data
    ji, ti = ivf
    ts, tix = T.ivf_topk(q, ti, K, nprobe=nprobe)
    assert ts.dtype == torch.float32 and tix.dtype == torch.int32
    js, jix = J.ivf_topk(jnp.asarray(q), ji, K, nprobe=nprobe,
                         backend="pallas", interpret=True)
    _same_up_to_ties(ts, tix, js, jix, IVF_TOL)
    # the oracle normalizes rows on the fly: rounding differs by ~1e-7
    rs, rix = j_ivf_ref(jnp.asarray(q), ji.centroids, ji.sup_cm, ji.ids_cm,
                        K, nprobe)
    _same_up_to_ties(ts, tix, rs, rix, IVF_TOL)
    ps, pix = R.ivf_topk_reference(torch.from_numpy(q), ti.centroids,
                                   ti.sup_cm, ti.ids_cm, K, nprobe)
    _same_up_to_ties(ps, pix, rs, rix, IVF_TOL)


def test_probe_matches_reference_and_breaks_ties_low(data, ivf):
    _, q = data
    ji, ti = ivf
    from repro.kernels.knn_ivf.ref import ivf_probe as j_probe
    np.testing.assert_array_equal(
        R.ivf_probe(torch.from_numpy(q), ti.centroids, 5).numpy(),
        np.asarray(j_probe(jnp.asarray(q), ji.centroids, 5)))
    cents = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    probe = R.ivf_probe(torch.tensor([[1.0, 0.0]]), cents, 3)
    assert probe.tolist() == [[0, 2, 1]]


def test_nprobe_all_equals_exact_search(data, ivf):
    s, q = data
    _, ti = ivf
    ts, tix = T.ivf_topk(q, ti, K, nprobe=ti.n_clusters)
    es, eix = knn_topk(torch.from_numpy(q), torch.from_numpy(s), K)
    _same_up_to_ties(ts, tix, es, eix, IVF_TOL)


def test_empty_slot_contract_on_short_lists():
    """A query whose probed lists hold fewer than k valid rows: the tail is
    -inf / -1, padding rows (inv 0, id -1) never score 0 or leak an id,
    and k above nprobe * L pads."""
    rng = np.random.default_rng(0)
    C, L, D = 3, 8, 16
    sup = rng.normal(size=(C, L, D)).astype(np.float32)
    ids = np.arange(C * L, dtype=np.int32).reshape(C, L)
    ids[:, 5:] = -1                                   # 5 valid rows a list
    sup[:, 5:] = 0.0
    inv = np.where(ids >= 0, 1.0 / np.maximum(np.linalg.norm(sup, axis=2),
                                               1e-12), 0.0)
    q = rng.normal(size=(2, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    probe = torch.tensor([[0, 2], [1, 0]], dtype=torch.int32)
    sc, ix = T.ivf_scan(torch.from_numpy(q), probe, torch.from_numpy(sup),
                        torch.from_numpy(ids),
                        torch.from_numpy(inv.astype(np.float32)), 20)
    assert sc.shape == (2, 20)
    assert torch.isfinite(sc[:, :10]).all() and (ix[:, :10] >= 0).all()
    assert torch.isinf(sc[:, 10:]).all() and (ix[:, 10:] == -1).all()
    assert set(ix[0, :10].tolist()) == set(ids[[0, 2]][:, :5].ravel())
    assert (sc[:, :-1] >= sc[:, 1:]).all()
    # the same contract through the ADC kernel's plain version
    m, nbits = 4, 8
    codes = rng.integers(0, 256, size=(C, m, L)).astype(np.uint8)
    cb = rng.normal(size=(m, 256, D // m)).astype(np.float32)
    anchors = rng.normal(size=(C, D)).astype(np.float32)
    sc, ix = T.ivfpq_adc(torch.from_numpy(q), probe, torch.from_numpy(codes),
                         torch.from_numpy(ids),
                         torch.from_numpy(inv.astype(np.float32)),
                         torch.from_numpy(anchors), torch.from_numpy(cb), 12,
                         m=m, nbits=nbits)
    assert torch.isfinite(sc[:, :10]).all() and (ix[:, 10:] == -1).all()
    assert torch.isinf(sc[:, 10:]).all()


# ---------------------------------------------------------------------------
# kernel 5: the ADC shortlist, and the two-stage search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nprobe", [2, 8])
def test_adc_plain_matches_pallas_and_decode_oracle(data, ivfpq, nprobe):
    _, q = data
    jp, tp = ivfpq
    ts, tix = T.ivfpq_topk(q, tp, K, nprobe=nprobe, rerank=0)
    js, jix = J.ivfpq_topk(jnp.asarray(q), jp, K, nprobe=nprobe, rerank=0,
                           backend="pallas", interpret=True)
    _same_up_to_ties(ts, tix, js, jix, ADC_ATOL, ADC_RTOL)
    os_, oix = j_adc_ref(jnp.asarray(q), jp.centroids, jp.anchors,
                         jp.codebooks, jp.codes_cm, jp.ids_cm, jp.inv_cm, K,
                         nprobe, jp.m, jp.nbits)
    _same_up_to_ties(ts, tix, os_, oix, ADC_ATOL, ADC_RTOL)
    ps, pix = R.ivfpq_adc_reference(
        torch.from_numpy(q), tp.centroids, tp.anchors, tp.codebooks,
        tp.codes_cm, tp.ids_cm, tp.inv_cm, K, nprobe, tp.m, tp.nbits)
    _same_up_to_ties(ps, pix, os_, oix, ADC_ATOL, ADC_RTOL)


@pytest.mark.parametrize("rerank", [1, 8])
def test_two_stage_matches_reference_fused(data, ivfpq, rerank):
    _, q = data
    jp, tp = ivfpq
    ts, tix = T.ivfpq_topk(q, tp, K, nprobe=8, rerank=rerank)
    js, jix = J.ivfpq_topk(jnp.asarray(q), jp, K, nprobe=8, rerank=rerank,
                           backend="fused")
    _same_up_to_ties(ts, tix, js, jix, IVF_TOL)


def test_search_clamps_k_like_reference(data, ivfpq):
    """k above nprobe * L and rerank above the candidates clamp exactly as
    the reference's fused dispatch clamps them."""
    _, q = data
    jp, tp = ivfpq
    big = tp.list_size + 5
    ts, tix = T.ivfpq_topk(q[:4], tp, big, nprobe=1, rerank=8)
    js, jix = J.ivfpq_topk(jnp.asarray(q[:4]), jp, big, nprobe=1, rerank=8,
                           backend="fused")
    assert ts.shape == tuple(np.asarray(js).shape) == (4, tp.list_size)
    _same_up_to_ties(ts, tix, js, jix, IVF_TOL)


def test_wrappers_reject_bad_arguments(ivf):
    _, ti = ivf
    q = torch.zeros((2, ti.sup_cm.shape[2]))
    probe = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="k >= 1"):
        T.ivf_scan(q, probe, ti.sup_cm, ti.ids_cm, ti.inv_cm, 0)
    with pytest.raises(ValueError, match="backend"):
        T.ivf_topk(q, ti, 5, backend="bogus")
    with pytest.raises(ValueError, match="inconsistent shapes"):
        T.ivfpq_adc(q, probe, torch.zeros((4, 3, 8), dtype=torch.uint8),
                    ti.ids_cm, ti.inv_cm, torch.zeros((4, q.shape[1])),
                    torch.zeros((8, 256, q.shape[1] // 8)), 5, m=8, nbits=8)


@pytest.fixture(scope="module")
def wide():
    """~1,500 rows in 12 lists: enough candidates for k = 1,100 at every
    list probed, and the JAX and port indexes built from the same bytes."""
    s, q = _clustered(N=1500, D=32, Q=6, seed=3)
    return (q, J.build_ivf_index(s, 12, seed=0),
            T.build_ivf_index(s, 12, seed=0, device="cpu"),
            J.build_ivfpq_index(s, 12, m=8, nbits=8, seed=0),
            T.build_ivfpq_index(s, 12, m=8, nbits=8, seed=0, device="cpu"))


@pytest.mark.parametrize("kind", ["ivf", "ivfpq", "ivfpq-adc"])
@pytest.mark.parametrize("k", [1100, 4000])
def test_search_above_1024_matches_reference(wide, kind, k):
    """k above one selection round (1,024) and above the rows the index
    holds: the same clamp and the same neighbours as the JAX package's
    plain paths (host traversal; the fused re-rank for IVF-PQ)."""
    q, ji, ti, jp, tp = wide
    nprobe = ti.n_clusters
    want = min(k, ti.n_rows)
    if kind == "ivf":
        ts, tix = T.ivf_topk(q, ti, k, nprobe=nprobe)
        js, jix = J.ivf_topk(jnp.asarray(q), ji, k, nprobe=nprobe)
        atol, rtol = IVF_TOL, 0.0
    elif kind == "ivfpq":
        ts, tix = T.ivfpq_topk(q, tp, k, nprobe=nprobe, rerank=2)
        js, jix = J.ivfpq_topk(jnp.asarray(q), jp, k, nprobe=nprobe,
                               rerank=2, backend="fused")
        atol, rtol = IVF_TOL, 0.0
    else:
        ts, tix = T.ivfpq_topk(q, tp, k, nprobe=nprobe, rerank=0)
        js, jix = J.ivfpq_topk(jnp.asarray(q), jp, k, nprobe=nprobe,
                               rerank=0)
        atol, rtol = ADC_ATOL, ADC_RTOL
    assert ts.shape == tix.shape == np.asarray(js).shape == (len(q), want)
    _same_up_to_ties(ts, tix, js, jix, atol, rtol)
    assert (tix >= 0).all()
