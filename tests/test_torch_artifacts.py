"""The artifact bridge between the two packages: a router saved by the JAX
package (`repro.core.routers.save_router`) loads in the port and predicts
the same, and one saved by the port loads in the JAX `load_router`; the
pinned legacy fixtures load in the port; a corrupt state file raises the
typed error; a streaming (dynamic) index crosses in both directions.
Predictions are compared at 1e-5 (f32 weighted means over k neighbours;
kth similarities of -inf compare equal)."""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dataset import RoutingDataset as JaxDataset  # noqa: E402
from repro.core.routers import load_router as jax_load  # noqa: E402
from repro.core.routers import make_router as jax_make  # noqa: E402
from repro.core.routers import save_router as jax_save  # noqa: E402
from repro_torch.core.dataset import RoutingDataset  # noqa: E402
from repro_torch.core.routers import (ArtifactCorruptError,  # noqa: E402
                                      load_router, make_router, save_router)
from repro_torch.kernels.knn_ivf.ops import DynamicIVFIndex  # noqa: E402
from repro_torch.serving.pipeline import RoutingPipeline  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TOL = 1e-5
SPECS = ["knn10", "knn20-ivf", "knn20-ivfpq@m=8,nbits=4"]


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
    return JaxDataset("d", X, S, C, names), RoutingDataset("d", X, S, C,
                                                           names), Q


@pytest.fixture(scope="module")
def data():
    return _datasets()


def _assert_same_predictions(a, b, Q):
    for x, y in zip(a.predict_with_confidence(Q), b.predict_with_confidence(Q)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=TOL)


@pytest.mark.parametrize("spec", SPECS)
def test_jax_artifact_loads_in_port(spec, data, tmp_path):
    jds, _, Q = data
    jr = jax_make(spec).fit(jds)
    path = jax_save(jr, tmp_path / "jax")
    tr = load_router(path, device="cpu")
    assert tr.index == jr.index and tr.k == jr.k
    assert tr.model_names == jr.model_names and tr.embed_dim == 32
    if jr.index == "ivfpq":
        assert tr._ivf.codes_h.tobytes() == jr._ivf.codes_h.tobytes()
    elif jr.index == "ivf":
        assert tr._ivf.sup_h.tobytes() == jr._ivf.sup_h.tobytes()
    np.testing.assert_array_equal(tr._X, jr._X)   # ivf*: rebuilt from rows()
    _assert_same_predictions(tr, jr, Q)


@pytest.mark.parametrize("spec", SPECS)
def test_port_artifact_loads_in_jax(spec, data, tmp_path):
    _, tds, Q = data
    pipe = RoutingPipeline(spec + ("," if "@" in spec else "@") + "lam=0.25",
                           device="cpu").fit(tds)
    path = pipe.save(tmp_path / "port")
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["format_version"] == 6 and "device" not in \
        manifest["config"]
    jr = jax_load(path)
    assert jr.default_lam == 0.25 and jr.index == pipe.router.index
    _assert_same_predictions(pipe.router, jr, Q)
    # and back: the port reloads its own artifact to the same predictions
    _assert_same_predictions(RoutingPipeline.load(path, device="cpu").router,
                             pipe.router, Q)


@pytest.mark.parametrize("version", [1, 2])
def test_pinned_fixtures_load_in_port_like_jax(version):
    path = FIXTURES / f"artifact_v{version}"
    tr = load_router(path, device="cpu")
    jr = jax_load(path)
    assert tr.index == ("ivf" if version == 1 else "ivfpq")
    assert tr.model_names == ["model-a", "model-b"]
    Q = np.random.default_rng(version).normal(size=(5, 8)).astype(np.float32)
    _assert_same_predictions(tr, jr, Q)


def test_dispatch_policy_round_trips_unchanged(data, tmp_path):
    from repro.core.routers.dispatch import DispatchPolicy
    jds, _, _ = data
    jr = jax_make("knn20-ivfpq@m=8").fit(jds)
    jr.dispatch_policy = DispatchPolicy(
        cells={"ivfpq": {"64": {"0": "fused"}}}, batch_edges=(64,),
        tiles={"ivfpq": {"probe_chunk": 4}})
    src = jax_save(jr, tmp_path / "a")
    tr = load_router(src, device="cpu")
    from repro_torch.core.routers.dispatch import DispatchPolicy as TPolicy
    assert isinstance(tr.dispatch_policy, TPolicy)
    assert tr.dispatch_policy.to_dict() == jr.dispatch_policy.to_dict()
    dst = save_router(tr, tmp_path / "b")
    assert json.loads((dst / "manifest.json").read_text())[
        "dispatch_policy"] == jr.dispatch_policy.to_dict()
    assert jax_load(dst).dispatch_policy == jr.dispatch_policy


def test_corrupt_state_raises_typed_error(data, tmp_path):
    _, tds, _ = data
    r = make_router("knn10-ivf", device="cpu").fit(tds)
    path = save_router(r, tmp_path / "a")
    raw = bytearray((path / "state.npz").read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (path / "state.npz").write_bytes(bytes(raw))
    with pytest.raises(ArtifactCorruptError, match="state_sha256"):
        load_router(path, device="cpu")
    # without a checksum (format <= 5) the truncated zip itself is caught
    manifest = json.loads((path / "manifest.json").read_text())
    del manifest["state_sha256"]
    (path / "manifest.json").write_text(json.dumps(manifest))
    (path / "state.npz").write_bytes(bytes(raw[:100]))
    with pytest.raises(ArtifactCorruptError, match="npz"):
        load_router(path, device="cpu")
    (path / "manifest.json").write_text("{not json")
    with pytest.raises(ArtifactCorruptError, match="json"):
        load_router(path, device="cpu")
    shutil.rmtree(path)
    with pytest.raises(ArtifactCorruptError, match="missing"):
        load_router(path, device="cpu")


def test_streaming_tier_raises_typed_error(data, tmp_path):
    """Dynamic artifacts both ways: a JAX router with a pending delta tier
    loads in the port (the tier bitwise, the counters, the build
    parameters) and predicts alike on its default backend; the port's saves
    back and loads in the JAX package alike.  A port save joins a
    background compaction still running first."""
    jds, pds, Q = data
    rng = np.random.default_rng(4)
    new = rng.normal(size=(40, 32)).astype(np.float32)
    new_s = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    jr = jax_make("knn10-ivfpq@online=1,delta_cap=50,m=8").fit(jds)
    jr.partial_fit(new, new_s)
    pr = load_router(jax_save(jr, tmp_path / "dyn"), device="cpu")
    assert isinstance(pr._ivf, DynamicIVFIndex) and pr.online
    np.testing.assert_array_equal(pr._ivf.delta_x, jr._ivf.delta_x)
    np.testing.assert_array_equal(pr._ivf.delta_assign, jr._ivf.delta_assign)
    # unset build parameters (None) are stored as -1 and not restored
    set_kw = {k: v for k, v in jr._ivf.build_kw.items() if v is not None}
    assert (pr._ivf.appends, pr._ivf.reclusters, pr._ivf.delta_cap,
            pr._ivf.build_kw) == (jr._ivf.appends, jr._ivf.reclusters, 50,
                                  set_kw)
    _assert_same_predictions(jr, pr, Q)
    back = jax_load(save_router(pr, tmp_path / "back"))
    np.testing.assert_array_equal(back._ivf.delta_x, jr._ivf.delta_x)
    _assert_same_predictions(back, pr, Q)
    # the port's own streaming router, mid-compaction at save time
    tr = make_router("knn10-ivf@online=1,delta_cap=20", device="cpu").fit(
        pds)
    tr.partial_fit(new, new_s, recluster="background")
    path = save_router(tr, tmp_path / "port")
    assert not tr._ivf.recluster_pending and tr._ivf.reclusters == 1
    jb = jax_load(path)
    assert jb._ivf.reclusters == 1 and jb._ivf.delta_rows == 0
    np.testing.assert_array_equal(np.asarray(jb._ivf.base.ids_cm),
                                  tr._ivf.base.ids_h)
    _assert_same_predictions(jb, tr, Q)


# ---------------------------------------------------------------------------
# the learned families: every family of the registry crosses both ways
# ---------------------------------------------------------------------------

#: one spec per learned family of REGISTRY (the kNN family is SPECS above);
#: linear and mlp also carry a fitted selection head (``_sel_params``)
LEARNED = ["linear", "linear_mf", "mlp", "mlp_mf", "graph10", "attn10",
           "dattn10", "linucb"]


def _kw(spec):
    return {} if spec in ("linear", "linucb") else {"epochs": 1}


def _fit(make, spec, ds, **extra):
    r = make(spec, **_kw(spec), **extra).fit(ds)
    if spec in ("linear", "mlp"):
        r.fit_selection(ds, 0.5 / ds.c_max)
        r.fit(ds)                  # the utility fit beside the head
    return r


def _leaves(path):
    with np.load(path / "state.npz") as z:
        return {k: z[k].shape for k in z.files}


def _assert_same_learned(a, b, Q, spec):
    for x, y in zip(a.predict_utility(Q), b.predict_utility(Q)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=TOL)
    if spec in ("linear", "mlp"):
        assert (np.asarray(a.select(Q)) == np.asarray(b.select(Q))).all()


@pytest.fixture(scope="module")
def learned_saved(data, tmp_path_factory):
    """Each learned family fitted once in each package and saved."""
    jds, tds, _ = data
    root = tmp_path_factory.mktemp("learned")
    out = {}
    for spec in LEARNED:
        jr = _fit(jax_make, spec, jds)
        tr = _fit(make_router, spec, tds, device="cpu")
        out[spec] = (jr, jax_save(jr, root / f"{spec}-jax"),
                     tr, save_router(tr, root / f"{spec}-port"))
    return out


@pytest.mark.parametrize("spec", LEARNED)
def test_learned_jax_artifact_loads_in_port(spec, data, learned_saved,
                                            tmp_path):
    _, _, Q = data
    jr, jpath, _, _ = learned_saved[spec]
    tr = load_router(jpath, device="cpu")
    assert type(tr).__name__ == type(jr).__name__
    assert tr.model_names == jr.model_names and tr.embed_dim == 32
    _assert_same_learned(tr, jr, Q, spec)
    # written back by the port: the same manifest keys and leaves
    back = save_router(tr, tmp_path / "back")
    mj = json.loads((jpath / "manifest.json").read_text())
    mt = json.loads((back / "manifest.json").read_text())
    assert sorted(mt) == sorted(mj) and mt["config"] == mj["config"]
    assert _leaves(back) == _leaves(jpath)


@pytest.mark.parametrize("spec", LEARNED)
def test_learned_port_artifact_loads_in_jax(spec, data, learned_saved,
                                            tmp_path):
    _, _, Q = data
    _, jpath, tr, tpath = learned_saved[spec]
    jr = jax_load(tpath)
    assert type(jr).__name__ == type(tr).__name__
    _assert_same_learned(tr, jr, Q, spec)
    assert _leaves(tpath) == _leaves(jpath)
    back = jax_save(jr, tmp_path / "back")
    assert sorted(json.loads((back / "manifest.json").read_text())) == \
        sorted(json.loads((tpath / "manifest.json").read_text()))
    assert _leaves(back) == _leaves(tpath)
