"""Shared by the CPU tests that hold the port's learned routers against the
JAX package's: the small dataset both packages generate, the reference's
initial weights as a flat {artifact path: array} dict, and fits of both
packages from those weights (the port's own init method patched on the
instance), with the losses each trainer returned."""
import contextlib

import jax
import numpy as np

from repro.core.routers import make_router as jax_make
from repro.core.routers import nn_utils as jax_nn
from repro.core.routers.artifacts import _flatten_tree
from repro.data.prices import ROUTERBENCH
from repro.data.synthetic import GenSpec as JaxGenSpec
from repro.data.synthetic import generate as jax_generate
from repro_torch.core.routers import make_router
from repro_torch.data.synthetic import GenSpec, generate
from repro_torch.models.convert import router_params_from_jax

#: the small dataset of the fits: 300 queries (210 train, 60 test) of 64
#: dimensions over RouterBench's 11 models
SMALL = dict(name="small", n_queries=300, ambient_dim=64, seed=1)


def small_datasets():
    models = ROUTERBENCH["RouterBench"]
    return (jax_generate(JaxGenSpec(models=models, **SMALL)),
            generate(GenSpec(models=models, **SMALL)))


def flat_numpy(tree):
    out = {}
    _flatten_tree(tree, "", out)
    return {k[1:]: np.asarray(v) for k, v in out.items()}


def jax_init(jr, D, M, seed=0, selection=False):
    """The reference router's initial parameter tree, flattened: the
    families with an ``_init`` method use it; the MLP and the linear
    selection head draw inline in the reference's fit, repeated here."""
    key = jax.random.PRNGKey(seed)
    family = jr.spec_family
    if selection and family == "linear":
        return flat_numpy(jax_nn.linear_init(key, D, M))
    if selection and family == "mlp":
        return flat_numpy({"mlp": jax_nn.mlp_params(
            key, [D, jr.hidden, jr.hidden, M])})
    if family == "mlp":
        ks = jax.random.split(key, 2)
        dims = [D, jr.hidden, jr.hidden, M]
        return flat_numpy({"mlp_s": jax_nn.mlp_params(ks[0], dims),
                           "mlp_c": jax_nn.mlp_params(ks[1], dims)})
    return flat_numpy(jr._init(key, D, M))


@contextlib.contextmanager
def jax_losses():
    """Records the last loss of every reference `nn_utils.train` call."""
    seen = []
    orig = jax_nn.train

    def train(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out[1])
        return out
    jax_nn.train = train
    try:
        yield seen
    finally:
        jax_nn.train = orig


def fit_both(spec, jds, ds, selection_lam=None, **kw):
    """Fit ``spec`` in both packages from the reference's initial weights:
    returns (jax router, port router on the CPU, reference last loss)."""
    jr = jax_make(spec, **kw)
    pr = make_router(spec, device="cpu", **kw)
    sel = selection_lam is not None
    flat = jax_init(jr, ds.dim, ds.n_models, selection=sel)
    setattr(pr, "_sel_init" if sel else "_init",
            lambda gen, D, M: router_params_from_jax(flat, device="cpu"))
    with jax_losses() as seen:
        if sel:
            jr.fit_selection(jds, selection_lam)
            pr.fit_selection(ds, selection_lam)
        else:
            jr.fit(jds)
            pr.fit(ds)
    return jr, pr, seen[-1]


def carried(jr, spec, **kw):
    """A port router on the CPU holding the fitted reference's state."""
    pr = make_router(spec, device="cpu", **kw)
    pr.load_state_dict(jr.state_dict())
    pr.model_names, pr.embed_dim = list(jr.model_names), jr.embed_dim
    return pr
