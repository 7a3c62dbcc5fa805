"""The port's neighbour-based learned routers (graph, attn, dattn) against
the JAX package's, on the CPU: the neighbours come from the port's
`knn_topk` (its plain version on a CPU tensor), the train split queries
itself and drops each row's own id.

Tolerances as in `test_torch_learned.py`: forward passes at carried
weights 1e-5 (scores; costs over the cost scale), fits of 2 epochs from the
reference's initial weights 1e-4 (loss relative, predictions absolute;
measured up to 4.8e-7).  The self-query ids are held equal: the small
dataset has no near-duplicate rows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.knn_topk.ops import knn_topk as jax_knn  # noqa: E402
from repro_torch.core.routers.base import normalize_rows  # noqa: E402
from torch_learned_helpers import carried, fit_both, small_datasets  # noqa: E402

TOL = 1e-5
FIT_TOL = 1e-4


@pytest.fixture(scope="module")
def data():
    jds, ds = small_datasets()
    return jds, ds, ds.part("test")[0]


@pytest.fixture(scope="module", params=["graph10", "attn10", "dattn10"])
def fitted(request, data):
    jds, ds, _ = data
    spec = request.param
    return (spec,) + fit_both(spec, jds, ds, epochs=2)


def _close(a, b, tol, scale=1.0):
    err = float(np.abs(np.asarray(a) - np.asarray(b)).max()) / scale
    assert err <= tol, err


def test_neighbour_forward_at_carried_weights(fitted, data):
    spec, jr, _, _ = fitted
    X = data[2]
    js, jc = jr.predict_utility(X)
    ps, pc = carried(jr, spec, epochs=2).predict_utility(X)
    _close(ps, js, TOL)
    _close(pc, jc, TOL, jr._c_scale)


def test_neighbour_fit_from_carried_init(fitted, data):
    spec, jr, pr, jloss = fitted
    X = data[2]
    first, last = pr.train_losses
    assert np.isfinite(first) and abs(last - jloss) <= FIT_TOL * abs(jloss)
    js, jc = jr.predict_utility(X)
    ps, pc = pr.predict_utility(X)
    _close(ps, js, FIT_TOL)
    _close(pc, jc, FIT_TOL, jr._c_scale)
    for attr in ("_X", "_Xraw", "_S", "_C"):
        assert getattr(pr, attr).tobytes() == np.asarray(
            getattr(jr, attr)).tobytes()


def test_self_query_drops_each_rows_own_id(fitted, data):
    """The fit's self-query: the port's ids equal the reference's, and each
    row's first neighbour, the one dropped, is the row itself."""
    spec, jr, pr, _ = fitted
    X = data[1].part("train")[0]
    got = pr._nbrs(X, exclude_self=True).numpy()
    want = np.asarray(jr._nbrs(X, exclude_self=True))
    assert (got == want).all()
    _, full = jax_knn(jnp.asarray(normalize_rows(X)), jnp.asarray(jr._X),
                      pr.k + 1)
    assert (np.asarray(full)[:, 0] == np.arange(len(X))).all()
