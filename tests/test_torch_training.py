"""The port's training slice (`repro_torch.training`, `repro_torch.data`,
`repro_torch.launch.train`) against the JAX package on the CPU: the
schedule and one AdamW update on the same numbers, three training steps of
reduced(mamba2-370m) from the same weights on the same `SyntheticLMStream`
batches, the checkpoint round trip, and the CLI.  Tolerance 1e-4 (f32; the
two frameworks sum in other orders, ~1e-6 per op)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.data.lm_data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.lm_data import SyntheticLMStream as JaxStream  # noqa: E402
from repro.models import model as jax_M  # noqa: E402
from repro.training import optimizer as jax_O  # noqa: E402
from repro.training.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.lm_data import DataConfig, SyntheticLMStream  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.training import checkpoint as CKPT  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

TOL = 1e-4


def test_lm_stream_batches_are_the_references():
    for seed, step in ((0, 0), (3, 7)):
        a = SyntheticLMStream(DataConfig(512, 33, 4, seed=seed)).batch(step)
        b = JaxStream(JaxDataConfig(512, 33, 4, seed=seed)).batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_schedule_matches_reference():
    opt = O.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jopt = jax_O.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(O.schedule(opt, step)),
            float(jax_O.schedule(jopt, jnp.asarray(step))), rtol=1e-6)


def test_update_matches_reference_with_clipping_and_decay():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    opt = O.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    jopt = jax_O.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                           clip_norm=0.5)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = O.init(tp)
    jp, jstate = params, jax_O.init(params)
    for step in range(3):
        grads = {k: (rng.normal(size=v.shape) * (step + 1)).astype(
            np.float32) for k, v in params.items()}
        met = O.update(opt, {k: torch.from_numpy(v) for k, v in
                             grads.items()}, state, tp)
        jp, jstate, jmet = jax_O.update(jopt, grads, jstate, jp)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                                   rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6)
            for part in ("m", "v", "master"):
                np.testing.assert_allclose(state[part][k].numpy(),
                                           np.asarray(jstate[part][k]),
                                           atol=1e-6, rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_three_train_steps_match_reference():
    """reduced(mamba2-370m) from the same weights, three steps on the same
    zipf batches (S = 40: a padded last SSD chunk): every step's loss and
    grad norm, then every parameter, within 1e-4."""
    jcfg = jax_reduced(jax_get_config("mamba2-370m"))
    cfg = reduced(get_config("mamba2-370m"))
    params = jax_M.init_params(jax.random.PRNGKey(1), jcfg)
    lm = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    opt = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    jopt = jax_O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, 40, 3, seed=2))
    step_fn = make_train_step(cfg, opt)
    jstep = jax.jit(jax_step(jcfg, jopt))
    state, jstate = O.init(dict(lm.named_parameters())), jax_O.init(params)
    for step in range(3):
        batch = stream.batch(step)
        met = step_fn(lm, state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        params, jstate, jmet = jstep(params, jstate,
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        for key in ("loss", "grad_norm", "total_loss", "tokens"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       atol=TOL, rtol=TOL, err_msg=key)
    want = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    got = dict(lm.named_parameters())
    for name, w in want.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   w.detach().numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_checkpoint_round_trip_and_validation(tmp_path):
    cfg = reduced(get_config("mamba2-370m"), dtype="bfloat16")
    from repro_torch.models import model as M
    lm = M.init_params(cfg, seed=0, device="cpu")
    tree = {"params": dict(lm.named_parameters()),
            "opt": O.init(dict(lm.named_parameters()))}
    path = str(tmp_path / "ck" / "state.npz")
    CKPT.save(path, tree)
    other = M.init_params(cfg, seed=1, device="cpu")
    template = {"params": dict(other.named_parameters()),
                "opt": O.init(dict(other.named_parameters()))}
    back = CKPT.restore(path, template)
    for name, p in tree["params"].items():
        r = back["params"][name]
        assert r.dtype == p.dtype
        assert torch.equal(r, p.detach())
    assert torch.equal(back["opt"]["master"]["embed"],
                       tree["opt"]["master"]["embed"])
    assert int(back["opt"]["step"]) == 0
    bad = {"params": {"embed": torch.zeros(3, 3)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        CKPT.restore(path, bad)
    with pytest.raises(KeyError, match="missing leaf"):
        CKPT.restore(path, {"params": {"nope": torch.zeros(1)}})


def test_train_cli_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    ck = str(tmp_path / "out.npz")
    hist = train.main(["--arch", "mamba2-370m", "--reduced", "--device",
                       "cpu", "--steps", "5", "--batch", "2", "--seq", "32",
                       "--ckpt", ck])
    assert len(hist) == 5 and all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    out = capsys.readouterr().out
    assert "[train] mamba2-370m-smoke" in out and "saved checkpoint" in out
    assert "blocks.0.ssm.A_log" in np.load(ck).files


def test_train_ab_runs_both_checkouts_in_turns():
    """`launch.ab`'s train child runs A, B, B, A, each in its own process
    from its own checkout; here both are this checkout, on the CPU."""
    from pathlib import Path
    from repro_torch.launch import ab
    root = Path(__file__).resolve().parents[1]
    res = ab.main(["--a", str(root), "--b", str(root), "train", "--",
                   "--arch", "mamba2-370m", "--reduced", "--device", "cpu",
                   "--steps", "2", "--batch", "2", "--seq", "32"])
    assert [r["run"] for r in res] == list("ABBA")
    for r in res:
        assert len(r["step_wall_s"]) == 2
        assert r["median_step_wall_s_after_first"] == r["step_wall_s"][1]
        assert r["tokens_per_s"] == 2 * 32 / r["step_wall_s"][1]
