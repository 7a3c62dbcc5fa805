"""The port's sharded steps (`launch.shardings.shard_lm`, `launch.steps`:
FSDP2 over "data", DTensor tensor parallelism over "model") on the CPU,
against the port's unsharded step in the same process, and the
unsharded step against the reference's.

One gloo world of 2 ranks (a 1 x 2 mesh, "model" only) and one of 4 (2 x
2) are spawned once for the module (`torch_sharded_worker.py`, a
``FileStore`` in tmp), as `test_torch_distributed.py` spawns its worlds;
each writes its results to an ``.npz`` that the tests below read.  In
f32 on reduced configs (4 sequences of 32 tokens, 4 decode steps):

- train: 2 AdamW steps of qwen3-4b, mamba2-370m and deepseek-v2-236b,
  the last expert-parallel and not (each rank its own experts over their
  slots), capacity factor 8 so nothing drops; the oracle's aux is the
  contract's, the mean of the ranks' Switch losses (a data rank's rows
  each without expert parallelism): losses within 1e-5, the updated
  parameters, gathered, within 1e-5 relative L2;
- prefill logits and decode logits over 4 steps (sequence-sharded caches;
  also h2o-danube-1.8b's sliding-window ring cache past its wrap, 12
  steps over 8 rows) within 1e-5;
- the expert-parallel layer's output, aux and gradients (input, router,
  experts) against `moe_local`'s within 1e-5;
- qwen3-4b's train steps with the sequence sharded over "model" (the
  dry-run's ``--seq-parallel``), within 1e-5;
- a bf16 MoE model's f32 router (sharded over the whole mesh by hand):
  its gradient within 0.2 relative L2 of the unsharded one's (bf16
  rounding gives 0.07 at both worlds; an unaveraged data-parallel
  gradient would be off by 0.5 or more at world 4);
- the same model's gradient norm by the card's clip over local shards
  (`optimizer.sharded_sumsq`, an all-reduced scalar for each placement)
  within 1e-6 of `global_norm`'s.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
ARCHS = ("qwen3", "mamba2", "deepseek_ep", "deepseek")
TOL = 1e-5
ENV1 = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
        "MKL_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}


#: the reference's single-device train step (jitted), one step of reduced
#: qwen3-4b in f32 from ``PRNGKey(0)``, in a process of its own started
#: with the worlds: its weights, batch and metrics to an ``.npz``
REF_PROG = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.models import model as M
from repro.training import optimizer as O
from repro.training.train_step import make_train_step
cfg = reduced(get_config("qwen3-4b")).replace(dtype="float32")
params = M.init_params(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(0)
tok = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
step = jax.jit(make_train_step(cfg, O.OptConfig()))
_, _, m = step(params, O.init(params),
               {k: jnp.asarray(v) for k, v in batch.items()})
flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
        np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(
            params)[0]}
np.savez(sys.argv[1], **{"p." + k: v for k, v in flat.items()}, **batch,
         **{"m." + k: np.asarray(v) for k, v in m.items()})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [rank outputs], "ref": the reference's step}: both worlds
    and the reference started together."""
    tmp = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ENV1)
    procs = {"ref": subprocess.Popen(
        [sys.executable, "-c", REF_PROG, str(tmp / "ref.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    for w in WORLDS:
        (tmp / f"w{w}").mkdir()
        procs[w] = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_sharded_worker.py"),
             str(w), str(tmp / f"w{w}")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    logs = {w: p.communicate(timeout=400)[0] for w, p in procs.items()}
    for w, p in procs.items():
        assert p.returncode == 0, f"{w}:\n{logs[w][-6000:]}"
    out = {w: [dict(np.load(tmp / f"w{w}" / f"rank{r}.npz"))
               for r in range(w)] for w in WORLDS}
    out["ref"] = dict(np.load(tmp / "ref.npz"))
    return out


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()),
                                                 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_train_losses_match_unsharded(runs, world, arch):
    """Each step's loss, aux, total and gradient norm, on every rank (the
    metrics are replicated), against the unsharded step's."""
    for out in runs[world]:
        for key in ("loss", "aux_loss", "total_loss", "grad_norm"):
            got = out[f"{arch}_train_{key}"]
            ref = out[f"{arch}_train_{key}_ref"]
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                       err_msg=key)
        np.testing.assert_array_equal(out[f"{arch}_train_tokens"],
                                      out[f"{arch}_train_tokens_ref"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_updated_parameters_match_unsharded(runs, world, arch):
    """After 2 steps every parameter, gathered, within 1e-5 relative L2 of
    the unsharded step's (the whole state; each parameter too, with an
    absolute floor for those that start at 0)."""
    out = runs[world][0]
    names = [k[len(f"{arch}_param_"):-4] for k in out
             if k.startswith(f"{arch}_param_") and k.endswith("_ref")]
    assert names
    got = np.concatenate([out[f"{arch}_param_{n}"].ravel() for n in names])
    ref = np.concatenate([out[f"{arch}_param_{n}_ref"].ravel()
                          for n in names])
    assert rel_l2(got, ref) < TOL
    for n in names:
        np.testing.assert_allclose(out[f"{arch}_param_{n}"],
                                   out[f"{arch}_param_{n}_ref"], rtol=TOL,
                                   atol=TOL, err_msg=n)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_placements_follow_the_rules(runs, world, arch):
    """Every parameter of `shard_lm`'s model lies as its rule says (FSDP's
    shard over "data", DTensor's over "model")."""
    out = runs[world][0]
    keys = [k for k in out if k.startswith(f"{arch}_placements_")]
    assert keys
    for k in keys:
        assert out[k].all(), k


@pytest.mark.parametrize("arch", ARCHS + ("danube",))
@pytest.mark.parametrize("world", WORLDS)
def test_prefill_and_decode_match_unsharded(runs, world, arch):
    """Prefill logits of the rank's rows, and the decode logits of 4 steps
    over the sequence-sharded caches (h2o-danube-1.8b: 12 steps over a
    ring cache of 8 rows, 4 a rank at world 4, past its wrap), within 1e-5
    of the unsharded."""
    for out in runs[world]:
        for part in ("prefill", "decode"):
            np.testing.assert_allclose(out[f"{arch}_{part}"],
                                       out[f"{arch}_{part}_ref"], rtol=TOL,
                                       atol=TOL, err_msg=part)


@pytest.mark.parametrize("world", WORLDS)
def test_expert_parallel_gradients_match_local(runs, world):
    """The expert-parallel layer against `moe_local` on the whole batch:
    output, the aux contract (the mean of the ranks' Switch losses) and
    the gradients to the input, the router and each rank's experts."""
    for out in runs[world]:
        for key in ("y", "aux", "gx", "grouter", "gw_gate", "gw_up",
                    "gw_down"):
            np.testing.assert_allclose(out[f"ep_{key}"], out[f"ep_{key}_ref"],
                                       rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_sequence_parallel_train_matches_unsharded(runs, world):
    """With the rule table's "seq" on "model" (``--seq-parallel``) the
    residual stream is sequence-sharded: 2 qwen3-4b train steps' losses
    and updated parameters within 1e-5 of the unsharded step's."""
    for out in runs[world]:
        np.testing.assert_allclose(out["seqpar_loss"], out["seqpar_loss_ref"],
                                   rtol=TOL, atol=TOL)
    out = runs[world][0]
    assert rel_l2(out["seqpar_params"], out["seqpar_params_ref"]) < TOL


@pytest.mark.parametrize("world", WORLDS)
def test_f32_router_of_a_bf16_model(runs, world):
    for out in runs[world]:
        for ep in (0, 1):
            assert out[f"router{ep}_placements"].all()
            assert rel_l2(out[f"router{ep}_grad"],
                          out[f"router{ep}_grad_ref"]) < 0.2


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_norm_pass_matches_global_norm(runs, world):
    """The clip's norm over the bf16 MoE model's gradients (replicated,
    sharded over "model", over "data" and "model", and by hand over the
    whole mesh), by the card's scheme (`optimizer.sharded_sumsq`), within
    1e-6 of `global_norm`'s, the same on every rank."""
    for ep in (0, 1):
        got = [float(out[f"norm{ep}_sharded"]) for out in runs[world]]
        want = float(runs[world][0][f"norm{ep}_ref"])
        assert len(runs[world][0][f"norm{ep}_placements"]) >= 3
        assert got == [got[0]] * world
        np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=0)


def test_unsharded_step_matches_reference(runs):
    """The port's unsharded train step against the reference's
    single-device `make_train_step` on the same weights (`params_from_
    jax` of the reference's tree), qwen3-4b reduced in f32: loss, grad
    norm and total within 1e-4."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import convert
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step
    ref = runs["ref"]
    cfg = reduced(get_config("qwen3-4b")).replace(dtype="float32")
    tree = {}
    for k, v in ref.items():
        if k.startswith("p."):
            *path, leaf = k[2:].split(".")
            d = tree
            for part in path:
                d = d.setdefault(part, {})
            d[leaf] = v
    for key in ("stack", "encoder"):     # pattern slots: lists in the tree
        for part, slots in tree.get(key, {}).items():
            if part != "shared":
                tree[key][part] = [slots[str(i)] for i in range(len(slots))]
    lm = convert.params_from_jax(tree, cfg, device="cpu")
    got = make_train_step(cfg, O.OptConfig())(
        lm, O.init(dict(lm.named_parameters())),
        {k: torch.from_numpy(ref[k]) for k in ("tokens", "labels")})
    for key in ("loss", "grad_norm", "total_loss"):
        assert float(got[key]) == pytest.approx(float(ref["m." + key]),
                                                rel=1e-4, abs=1e-4), key


def test_remat_dots_saves_products_not_gradients():
    """``remat_policy="dots"`` (matrix products without batch dims saved)
    gives the gradients of ``"full"`` within 1e-6, in fewer FLOPs."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.models import model as M
    cfg = reduced(get_config("qwen3-4b")).replace(remat=True)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (2, 33)).astype(np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    res = {}
    for pol in ("full", "dots"):
        c = cfg.replace(remat_policy=pol)
        lm = M.init_params(c, seed=0, device="cpu")
        for p in lm.parameters():
            p.requires_grad_(True)

        def step():
            M.loss_fn(lm, c, batch)[0].backward()
        _, rec = CA.measure(step)
        res[pol] = rec.flops, {n: p.grad for n, p in lm.named_parameters()}
    assert res["dots"][0] < res["full"][0]
    for n, g in res["full"][1].items():
        torch.testing.assert_close(res["dots"][1][n], g, rtol=1e-6, atol=1e-6)
