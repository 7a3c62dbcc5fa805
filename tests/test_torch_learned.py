"""The port's learned routers without neighbours (linear, linear_mf,
mlp_mf, mlp, LinUCB) and their shared pieces (`nn_utils`, the registry)
against the JAX package's, on the CPU.

Tolerances:
  * forward passes at carried weights (the reference's fitted state loaded
    into the port): 1e-5 absolute on scores and on costs over the router's
    cost scale (f32 products in another order);
  * fits of 2 epochs from the reference's initial weights: 1e-4 on the
    last loss (relative) and on the predictions (AdamW divides by sqrt(v),
    which magnifies the products' rounding; measured up to 2.4e-5);
  * the selection heads, 60 epochs from the reference's initial weights:
    logits within 1e-4 (measured up to 3.3e-6), the choices of at least
    95% of the test queries equal (measured: all);
  * ridge weights and LinUCB bit-equal (numpy copies of the reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.routers import PAPER_ORDER as JAX_ORDER  # noqa: E402
from repro.core.routers import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.core.routers import make_router as jax_make  # noqa: E402
from repro.core.routers import nn_utils as jax_nn  # noqa: E402
from repro_torch.core.routers import (PAPER_ORDER, REGISTRY,  # noqa: E402
                                      make_router)
from repro_torch.core.routers import nn_utils as nn  # noqa: E402
from repro_torch.models.convert import router_params_from_jax  # noqa: E402
from torch_learned_helpers import (carried, fit_both, flat_numpy,  # noqa: E402
                                   small_datasets)

TOL = 1e-5
FIT_TOL = 1e-4
UTILITY = ["linear_mf", "mlp_mf", "mlp"]


@pytest.fixture(scope="module")
def data():
    jds, ds = small_datasets()
    return jds, ds, ds.part("test")[0]


@pytest.fixture(scope="module", params=UTILITY)
def fitted(request, data):
    jds, ds, _ = data
    spec = request.param
    return (spec,) + fit_both(spec, jds, ds, epochs=2)


def _close(a, b, tol, scale=1.0):
    err = float(np.abs(np.asarray(a) - np.asarray(b)).max()) / scale
    assert err <= tol, err


def test_registry_and_paper_order_equal_reference():
    assert PAPER_ORDER == JAX_ORDER
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    for name in REGISTRY:
        r = REGISTRY[name](device="cpu")
        assert type(r).__name__ == type(JAX_REGISTRY[name]()).__name__
        assert r.name == JAX_REGISTRY[name]().name
        assert r.is_parametric == JAX_REGISTRY[name]().is_parametric


@pytest.mark.parametrize("nh", [1, 4])
def test_nn_forward_matches_reference(nh):
    """`mlp_apply` and `mha` over (2, 3, 5, 16) tokens at the reference's
    initial weights."""
    key = jax.random.PRNGKey(3)
    mlp = jax_nn.mlp_params(key, [16, 24, 8])
    att = jax_nn.mha_init(key, 16, nh, 8)
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 16)).astype(np.float32)
    q = x[:, :, :1]
    want_m = np.asarray(jax_nn.mlp_apply(mlp, jnp.asarray(x)))
    want_a = np.asarray(jax_nn.mha(att, jnp.asarray(q), jnp.asarray(x), nh))
    pm = router_params_from_jax(flat_numpy({"m": mlp}), device="cpu")["m"]
    pa = router_params_from_jax(flat_numpy(att), device="cpu")
    _close(nn.mlp_apply(pm, torch.from_numpy(x)), want_m, TOL)
    _close(nn.mha(pa, torch.from_numpy(q), torch.from_numpy(x), nh),
           want_a, TOL)
    # flatten and unflatten invert each other on the reference's trees
    flat = nn.flatten_tree(pa)
    assert sorted(flat) == sorted(flat_numpy(att))
    assert nn.flatten_tree(nn.unflatten_tree(flat)).keys() == flat.keys()


def test_learned_forward_at_carried_weights(fitted, data):
    spec, jr, _, _ = fitted
    X = data[2]
    js, jc = jr.predict_utility(X)
    ps, pc = carried(jr, spec, epochs=2).predict_utility(X)
    _close(ps, js, TOL)
    _close(pc, jc, TOL, jr._c_scale)


def test_learned_fit_from_carried_init(fitted, data):
    spec, jr, pr, jloss = fitted
    X = data[2]
    first, last = pr.train_losses
    assert np.isfinite(first) and abs(last - jloss) <= FIT_TOL * abs(jloss)
    js, jc = jr.predict_utility(X)
    ps, pc = pr.predict_utility(X)
    _close(ps, js, FIT_TOL)
    _close(pc, jc, FIT_TOL, jr._c_scale)
    assert pr._c_scale == jr._c_scale


def test_ridge_weights_bit_equal(data):
    jds, ds, X = data
    jr = jax_make("linear").fit(jds)
    pr = make_router("linear", device="cpu").fit(ds)
    assert pr._Ws.tobytes() == np.asarray(jr._Ws).tobytes()
    assert pr._Wc.tobytes() == np.asarray(jr._Wc).tobytes()
    for a, b in zip(pr.predict_utility(X), jr.predict_utility(X)):
        _close(a, b, TOL, max(1.0, float(np.abs(b).max())))


def test_linucb_bit_equal(data):
    jds, ds, X = data
    jr = jax_make("linucb@lam=0.3").fit(jds)
    pr = make_router("linucb@lam=0.3", device="cpu").fit(ds)
    assert pr.lam == jr.lam == 0.3 and pr.default_lam == 0.3
    for attr in ("_proj", "_A_inv", "_b", "_b_cost"):
        assert getattr(pr, attr).tobytes() == getattr(jr, attr).tobytes()
    for a, b in zip(pr.predict_utility(X), jr.predict_utility(X)):
        assert a.tobytes() == b.tobytes()
    assert pr.online_replay(ds).tobytes() == jr.online_replay(jds).tobytes()
    assert pr._A_inv.tobytes() == jr._A_inv.tobytes()


@pytest.mark.parametrize("spec", ["linear", "mlp"])
def test_selection_head_matches_reference(spec, data):
    """The logistic / cross-entropy heads: at carried weights the logits to
    1e-5 and the choices equal; fitted 60 epochs from the reference's
    initial weights, logits to 1e-4 and >= 95% of the choices equal."""
    jds, ds, X = data
    lam = 0.5 / ds.c_max
    jr, pr, jloss = fit_both(spec, jds, ds, selection_lam=lam)
    head = "mlp" if spec == "mlp" else None

    def logits(params, package):
        if package == "jax":
            x = jnp.asarray(X)
            p = params[head] if head else params
            f = jax_nn.mlp_apply if head else jax_nn.linear
            return np.asarray(f(p, x))
        x = torch.from_numpy(X)
        p = params[head] if head else params
        f = nn.mlp_apply if head else nn.linear
        return f(p, x).numpy()

    want = logits(jr._sel_params, "jax")
    at = carried(jr, spec)
    _close(logits(at._sel_params, "torch"), want, TOL)
    assert (at.select(X) == jr.select(X)).all()
    assert abs(pr.train_losses[1] - jloss) <= FIT_TOL * abs(jloss)
    _close(logits(pr._sel_params, "torch"), want, FIT_TOL)
    assert (pr.select(X) == jr.select(X)).mean() >= 0.95
    assert pr._sel_lam == jr._sel_lam == lam


def test_select_before_fit_selection_raises_like_reference(data):
    jds, ds, X = data
    jr = jax_make("mlp_mf", epochs=1).fit(jds)
    pr = make_router("mlp_mf", epochs=1, device="cpu").fit(ds)
    with pytest.raises(RuntimeError) as want:
        jr.select(X)
    with pytest.raises(RuntimeError) as got:
        pr.select(X)
    assert str(got.value) == str(want.value)
    # the default selection is the utility argmax at the selection lambda
    pr.fit_selection(ds, 0.2)
    s, c = pr.predict_utility(X)
    assert (pr.select(X) == np.argmax(s - 0.2 * c, axis=1)).all()
