"""The paper's evaluation in the port against the JAX package, on the CPU:
the seeded benchmark suite (byte-equal datasets), the Pareto-AUC and
selection protocols (`core/eval.py`), the diagnostics, the kNN router's
neighbour vote (also after `partial_fit`, which extends the vote labels)
and `RoutingPipeline.fit_selection` / `evaluate`.

Tolerances: datasets byte-equal; the eval and diagnostics functions on the
same numpy inputs exactly, or to 1e-9 where a sum over many points may
round otherwise; the kNN utilities to 1e-5 (f32 neighbour means), so the
AUCs of the pipelines to 1e-4 on the 0-100 scale, and the votes equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import diagnostics as jax_diag  # noqa: E402
from repro.core import eval as jax_eval  # noqa: E402
from repro.core.routers import make_router as jax_make  # noqa: E402
from repro.data import routing_bench as jax_bench  # noqa: E402
from repro.serving.pipeline import RoutingPipeline as JaxPipeline  # noqa: E402
from repro_torch.core import diagnostics as diag  # noqa: E402
from repro_torch.core import eval as E  # noqa: E402
from repro_torch.core.routers import make_router  # noqa: E402
from repro_torch.data import routing_bench as bench  # noqa: E402
from repro_torch.serving.pipeline import RoutingPipeline  # noqa: E402
from repro_torch.models.convert import router_params_from_jax  # noqa: E402
from torch_learned_helpers import jax_init, small_datasets  # noqa: E402


def _same_dataset(a, b):
    assert a.name == b.name and a.model_names == b.model_names
    for f in ("embeddings", "scores", "costs", "train_idx", "val_idx",
              "test_idx"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.fixture(scope="module")
def suites():
    return ({"text": jax_bench.text_benchmarks(),
             "routerbench_tasks": jax_bench.routerbench_tasks(),
             "routerbench_combined": {"RouterBench":
                                      jax_bench.routerbench_combined()}},
            {"text": bench.text_benchmarks(),
             "routerbench_tasks": bench.routerbench_tasks(),
             "routerbench_combined": {"RouterBench":
                                      bench.routerbench_combined()}})


@pytest.fixture(scope="module")
def small():
    jds, ds = small_datasets()
    return jds, ds, ds.part("test")[0]


@pytest.mark.parametrize("suite", ["text", "routerbench_tasks",
                                   "routerbench_combined"])
def test_suite_datasets_byte_equal(suites, suite):
    want, got = suites[0][suite], suites[1][suite]
    assert list(got) == list(want)
    for name in want:
        _same_dataset(got[name], want[name])


def test_vlm_datasets_byte_equal():
    want, got = jax_bench.vlm_benchmarks(), bench.vlm_benchmarks()
    assert list(got) == list(want) and len(got) == 10
    for name in want:
        assert got[name].dim == 3584
        _same_dataset(got[name], want[name])


def test_full_suite_and_dataset_methods_byte_equal(suites):
    want, got = jax_bench.full_suite(), bench.full_suite()
    assert list(got) == list(want) and len(got) == 10
    a, b = suites[0]["routerbench_tasks"], suites[1]["routerbench_tasks"]
    _same_dataset(b["gsm"].with_ood_test(b["mbpp"]),
                  a["gsm"].with_ood_test(a["mbpp"]))
    idx = np.arange(0, 1200, 7)
    _same_dataset(b["arcc"].subset(idx), a["arcc"].subset(idx))
    for split in ("all", "train", "test"):
        assert (b["arcc"].normalized_embeddings(split).tobytes()
                == a["arcc"].normalized_embeddings(split).tobytes())
    assert b["arcc"].c_max == a["arcc"].c_max


def _points(seed, n=41):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 2e-3, n), rng.uniform(0.3, 0.9, n)], 1)


@pytest.mark.parametrize("fn", ["lambda_grid", "route_points",
                                "nondecreasing_hull", "hull_auc",
                                "cost_normalizer", "oracle_auc",
                                "random_auc", "utility_auc"])
def test_eval_functions_match_reference(fn, suites):
    jds = suites[0]["text"]["HELM-Lite/Google"]
    ds = suites[1]["text"]["HELM-Lite/Google"]
    X, S, C = ds.part("test")
    rng = np.random.default_rng(1)
    s_hat = (S + rng.normal(0, 0.2, S.shape)).astype(np.float32)
    c_hat = (C * rng.uniform(0.5, 1.5, C.shape)).astype(np.float32)

    class Fixed:
        def predict_utility(self, _):
            return s_hat, c_hat

    lams = E.lambda_grid(C.mean())
    got, want = {
        "lambda_grid": lambda: (E.lambda_grid(0.37, 17),
                                jax_eval.lambda_grid(0.37, 17)),
        "route_points": lambda: (
            E._route_points(s_hat, c_hat, S, C, lams),
            jax_eval._route_points(s_hat, c_hat, S, C, lams)),
        "nondecreasing_hull": lambda: (E.nondecreasing_hull(_points(2)),
                                       jax_eval.nondecreasing_hull(
                                           _points(2))),
        "hull_auc": lambda: (E.hull_auc(_points(3), 1.5e-3),
                             jax_eval.hull_auc(_points(3), 1.5e-3)),
        "cost_normalizer": lambda: (E.cost_normalizer(ds),
                                    jax_eval.cost_normalizer(jds)),
        "oracle_auc": lambda: (E.oracle_auc(ds)["points"],
                               jax_eval.oracle_auc(jds)["points"]),
        "random_auc": lambda: (E.random_auc(ds, n_draws=8, seed=4)["auc"],
                               jax_eval.random_auc(jds, n_draws=8,
                                                   seed=4)["auc"]),
        "utility_auc": lambda: (E.utility_auc(Fixed(), ds)["auc"],
                                jax_eval.utility_auc(Fixed(), jds)["auc"]),
    }[fn]()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert E.PRESETS == jax_eval.PRESETS


def test_diagnostics_match_reference(small):
    _, ds, _ = small
    X, S = ds.embeddings, ds.scores
    got = diag.locality_check(X, S, n_pairs=4000, n_bins=10, seed=2)
    want = jax_diag.locality_check(X, S, n_pairs=4000, n_bins=10, seed=2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9)
    assert diag.twonn_intrinsic_dim(X, max_n=200) == pytest.approx(
        jax_diag.twonn_intrinsic_dim(X, max_n=200), abs=1e-9)
    kth = np.linspace(-1, 1, 50)
    train = np.random.default_rng(0).uniform(-1, 1, 300)
    assert (diag.knn_confidence(kth, train)
            == jax_diag.knn_confidence(kth, train)).all()


@pytest.mark.parametrize("spec", ["knn10", "knn100", "knn20-ivf"])
def test_knn_vote_matches_reference_before_and_after_partial_fit(spec, small):
    """The neighbour vote after `fit_selection`, then after a `partial_fit`
    of 40 rows whose labels the vote must count: the port extends
    `_train_best` at the selection lambda, as the reference does."""
    jds, ds, X = small
    lam = 0.5 / ds.c_max
    jr = jax_make(spec).fit_selection(jds, lam)
    pr = make_router(spec, device="cpu").fit_selection(ds, lam)
    assert (pr._train_best == jr._train_best).all()
    assert (pr.select(X) == jr.select(X)).all()
    rng = np.random.default_rng(9)
    new = X[:40] + rng.normal(0, 1e-3, X[:40].shape).astype(np.float32)
    S = rng.uniform(0, 1, (40, ds.n_models)).astype(np.float32)
    C = np.full_like(S, 1e-4)
    jr.partial_fit(new, S, C)
    pr.partial_fit(new, S, C)
    assert len(pr._train_best) == len(pr._S) == len(jr._train_best)
    assert (pr._train_best == jr._train_best).all()
    assert (pr.select(X) == jr.select(X)).all()


def test_selection_utility_knn100_matches_reference(small):
    jds, ds, _ = small
    got = E.selection_utility(lambda: make_router("knn100", device="cpu"),
                              ds)
    want = jax_eval.selection_utility(lambda: jax_make("knn100"), jds)
    assert list(got) == list(want) == list(E.PRESETS) + ["avg"]
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9)


@pytest.mark.parametrize("spec", ["knn10", "linear", "linucb"])
def test_pipeline_evaluate_and_fit_selection_match_reference(spec, small):
    jds, ds, X = small
    jp = JaxPipeline(spec, seed=0).fit(jds)
    pp = RoutingPipeline(spec, seed=0, device="cpu").fit(ds)
    want, got = jp.evaluate(), pp.evaluate()
    assert got["c_ref"] == want["c_ref"]
    assert abs(got["auc"] - want["auc"]) <= 1e-4, (got["auc"], want["auc"])
    np.testing.assert_allclose(got["points"], want["points"], atol=1e-6)
    lam = 0.1 / ds.c_max
    if spec == "linear":
        # the logistic head starts from the reference's initial weights
        flat = jax_init(jp.router, ds.dim, ds.n_models, selection=True)
        pp.router._sel_init = lambda gen, D, M: router_params_from_jax(flat, device="cpu")
    jsel = jp.fit_selection(jds, lam).router.select(X)
    psel = pp.fit_selection(ds, lam).router.select(X)
    assert (psel == jsel).all()
    with pytest.raises(ValueError, match="needs a dataset"):
        RoutingPipeline(spec, device="cpu").evaluate()
