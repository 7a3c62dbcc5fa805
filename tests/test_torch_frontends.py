"""The port's front ends against `repro.models.model` at the reduced
configs, f32, with the reference's weights carried by `params_from_jax` and
seeded numpy inputs: internvl2-76b's patch prefix (projected patches ahead
of the text, their label slots ignored) and seamless-m4t-medium's frame
encoder with the decoder's cross attention, in the forward, the loss and
its gradients, a train step, the cached and the recomputed cross decode,
the train CLI and checkpoints that cross between the packages; and the
plain attention at the cross shapes (Sq != Sk, no mask) with its gradient
against `attend_ref` and `jax.vjp` of it.

Tolerance 1e-4 (abs and rel), as `test_torch_families.py`: the frameworks
sum the matmuls and softmaxes in other orders, which moves f32 results by
~1e-6 a layer; a dropped RoPE, a wrong mask or a missing norm moves them
by O(1e-2) or more."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import model as jax_M  # noqa: E402
from repro.models.attention import attend_ref  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import optimizer as jax_O  # noqa: E402
from repro.training.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_reference)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.training import checkpoint as CKPT  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

TOL = 1e-4
VISION, AUDIO = "internvl2-76b", "seamless-m4t-medium"
NAMES = (VISION, AUDIO)


def assert_same_config(jcfg, cfg):
    """The port's config equals the reference's in every field the
    reference has; the port's own fields (the MoE router's kind, a held
    expert block, RoPE scaling, the balance loss's weight) keep their
    defaults, which are the reference's behaviour."""
    import dataclasses
    port = vars(cfg)
    assert vars(jcfg) == {k: port[k] for k in vars(jcfg)}
    extra = {f.name: f.default for f in dataclasses.fields(cfg)
             if f.name not in vars(jcfg)}
    assert {k: port[k] for k in extra} == extra


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _model(name, seed=3):
    jcfg = jax_reduced(jax_get_config(name))
    cfg = reduced(get_config(name))
    assert_same_config(jcfg, cfg)
    params = jax_M.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, params, params_from_jax(_np_tree(params), cfg,
                                              device="cpu")


def _batch(cfg, B=2, S=12, Se=10, seed=4):
    """Tokens and labels (three ignored), and N(0, 1) patches (vision) or
    frames (audio) of the reduced front-end width."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.frontend == "vision":
        batch["patches"] = rng.normal(size=(B, cfg.num_patches,
                                            cfg.frontend_dim)).astype(
            np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(B, Se, cfg.frontend_dim)).astype(
            np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=what)


def _leaves_equal(got, want, cmp):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = functools.reduce(lambda t, p: t[getattr(p, "key",
                                                    getattr(p, "idx", p))],
                             path, got)
        cmp(np.asarray(g), np.asarray(w), jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", NAMES)
def test_front_end_configs_are_copies_of_the_reference(name):
    assert_same_config(jax_get_config(name),
                       get_config(name))
    assert_same_config(jax_reduced(jax_get_config(name)),
                       reduced(get_config(name)))


def test_encoder_matches_reference():
    """`encode`: the projected frames through the bidirectional encoder
    (RoPE on, no mask) and ``enc_norm``; a causal encoder would differ."""
    jcfg, cfg, params, lm = _model(AUDIO)
    frames = _batch(cfg, Se=20)["frames"]
    want = jax.jit(lambda p, f: jax_M.encode(p, jcfg, f))(
        params, jnp.asarray(frames))
    with torch.no_grad():
        got = M.encode(lm, cfg, torch.from_numpy(frames))
    assert got.shape == (2, 20, cfg.d_model)
    _close(got, want, "enc_out")
    with torch.no_grad():
        first = M.encode(lm, cfg, torch.from_numpy(frames[:, :10]))
    # bidirectional: the first ten rows see the last ten
    assert float((first - got[:, :10]).abs().max()) > 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    """Logits of `forward`: (B, P + S, vocab) with the patch prefix, (B, S,
    vocab) for the encoder-decoder with its cross attention."""
    jcfg, cfg, params, lm = _model(name)
    batch = _batch(cfg)
    jb, tb = _both({k: v for k, v in batch.items() if k != "labels"})
    jl, jaux = jax.jit(lambda p, b: jax_M.forward(p, jcfg, b))(params, jb)
    with torch.no_grad():
        tl, aux = M.forward(lm, cfg, tb)
    P = cfg.num_patches if name == VISION else 0
    assert tl.shape == (2, P + 12, cfg.vocab_size)
    _close(tl, jl, "logits")
    _close(aux, jaux, "aux")


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name):
    """`loss_fn` (a vision batch's labels padded with -1 over the patch
    slots) and the gradient of every leaf (``frontend_proj``, the encoder,
    ``cross`` / ``norm_cross`` included) against jax.value_and_grad."""
    jcfg, cfg, params, lm0 = _model(name)
    lm = copy.deepcopy(lm0)
    jb, tb = _both(_batch(cfg))
    (jtot, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_M.loss_fn(p, jcfg, jb), has_aux=True))(params)
    lm.requires_grad_(True)
    tot, met = M.loss_fn(lm, cfg, tb)
    tot.backward()
    _close(tot.detach(), jtot, "total loss")
    assert float(met["tokens"]) == float(jmet["tokens"]) == 2 * 12 - 3
    grads = {n: p.grad for n, p in lm.named_parameters()}
    assert all(g is not None for g in grads.values())
    if name == VISION:
        assert float(grads["frontend_proj"].abs().max()) > 0
    else:
        assert float(grads["blocks.1.cross.wk"].abs().max()) > 0
        assert float(grads["encoder.0.attn.wq"].abs().max()) > 0
    _leaves_equal(params_to_jax(grads, cfg), _np_tree(jg),
                  lambda g, w, what: _close(g, w, what))


@pytest.mark.parametrize("name,remat", [(VISION, False), (AUDIO, False),
                                        (AUDIO, True)])
def test_train_steps_match_reference(name, remat):
    """Two AdamW steps from the same weights on the same batch: each step's
    loss and grad norm, then every parameter; ``remat`` recomputes each
    decoder and encoder layer in the backward pass, as the reference's
    checkpointed scan."""
    jcfg, cfg, params, lm0 = _model(name)
    jcfg, cfg = jcfg.replace(remat=remat), cfg.replace(remat=remat)
    lm = copy.deepcopy(lm0)
    opt = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    jopt = jax_O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    step_fn, jstep = make_train_step(cfg, opt), jax.jit(jax_step(jcfg, jopt))
    state, jstate = O.init(dict(lm.named_parameters())), jax_O.init(params)
    jb, tb = _both(_batch(cfg, seed=7))
    for _ in range(2):
        met = step_fn(lm, state, tb)
        params, jstate, jmet = jstep(params, jstate, jb)
        for key in ("loss", "grad_norm", "total_loss", "tokens"):
            _close(float(met[key]), float(jmet[key]), key)
    want = params_from_jax(_np_tree(params), cfg, device="cpu")
    got = dict(lm.named_parameters())
    for n, w in want.named_parameters():
        _close(got[n].detach(), w.detach(), n)


def _jax_decode(params, jcfg, toks, enc_out, cache_len):
    """The reference's teacher-forced decode: scalar positions 0..T-1,
    the cross K / V cached (``cross_kv_cache``) or ``enc_out`` each step."""
    B = toks.shape[0]
    cached = jcfg.is_encoder_decoder and jcfg.cross_kv_cache
    enc_len = enc_out.shape[1] if enc_out is not None else 0
    caches = jax_M.init_caches(jcfg, B, cache_len, enc_len=enc_len)
    if cached:
        caches = jax_M.fill_cross_cache(params, jcfg, caches, enc_out)
    step = jax.jit(lambda p, c, t, q, e: jax_M.decode_step(
        p, jcfg, c, t, q, enc_out=e))
    out = []
    for t in range(toks.shape[1]):
        logits, caches = step(params, caches, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t), None if cached else enc_out)
        out.append(np.asarray(logits))
    return np.stack(out, 1)


def _port_decode(lm, cfg, toks, enc_out, cache_len):
    B = toks.shape[0]
    enc_len = enc_out.shape[1] if enc_out is not None else 0
    caches = M.init_caches(cfg, B, cache_len, "cpu", enc_len=enc_len)
    if enc_out is not None and cfg.cross_kv_cache:
        M.fill_cross_cache(lm, cfg, caches, enc_out)
        enc_out = None
    out = []
    for t in range(toks.shape[1]):
        logits, caches = M.decode_step(lm, cfg, caches,
                                       torch.from_numpy(toks[:, t:t + 1]),
                                       torch.full((B,), t), enc_out=enc_out)
        out.append(logits.numpy())
    return np.stack(out, 1)


@pytest.mark.parametrize("name,cached", [(AUDIO, True), (AUDIO, False),
                                         (VISION, True)])
def test_teacher_forced_decode_matches_reference(name, cached):
    """Ten decode steps of two slots against the reference's `decode_step`:
    the encoder-decoder with its cross K / V cached (`fill_cross_cache`,
    the decode kernel at position Se - 1) or projected from ``enc_out``
    every step (the forward kernel at Sq 1); the vision model decodes text
    (the reference's decode takes no patches).  Each against the port's
    own forward too, as the reference's test_models checks cached against
    recompute against forward."""
    jcfg, cfg, params, lm = _model(name)
    jcfg = jcfg.replace(cross_kv_cache=cached)
    cfg = cfg.replace(cross_kv_cache=cached)
    batch = _batch(cfg, S=10, Se=14, seed=9)
    toks = batch["tokens"]
    enc, jenc = None, None
    if cfg.is_encoder_decoder:
        frames = batch["frames"]
        jenc = jax_M.encode(params, jcfg, jnp.asarray(frames))
        with torch.no_grad():
            enc = M.encode(lm, cfg, torch.from_numpy(frames))
    got = _port_decode(lm, cfg, toks, enc, 16)
    _close(got, _jax_decode(params, jcfg, toks, jenc, 16), "decode")
    fb = {"tokens": torch.from_numpy(toks)}
    if cfg.is_encoder_decoder:
        fb["frames"] = torch.from_numpy(batch["frames"])
    with torch.no_grad():
        full = M.forward(lm, cfg, fb)[0].numpy()
    _close(got, full, "decode against forward")


def test_cross_caches_follow_the_reference_layout():
    """`init_caches(enc_len=)` adds (B, Se, KV, hd) cross K / V to each
    decoder layer, none with ``cross_kv_cache`` off or for a vision model;
    `fill_cross_cache` writes `cross_kv` of each layer (no ``k_norm``)."""
    jcfg, cfg, params, lm = _model(AUDIO)
    caches = M.init_caches(cfg, 2, 16, "cpu", enc_len=14)
    jc = jax_M.init_caches(jcfg, 2, 16, enc_len=14)
    for layer in caches:
        assert set(layer) == {"k", "v", "ck", "cv"}
        assert layer["ck"].shape == (2, 14, cfg.n_kv_heads, cfg.head_dim)
    assert jc["groups"][0]["ck"].shape[1:] == caches[0]["ck"].shape
    off = M.init_caches(cfg.replace(cross_kv_cache=False), 2, 16, "cpu",
                        enc_len=14)
    assert all(set(layer) == {"k", "v"} for layer in off)
    vis = M.init_caches(_model(VISION)[1], 2, 16, "cpu", enc_len=14)
    assert all(set(layer) == {"k", "v"} for layer in vis)
    enc = torch.from_numpy(_batch(cfg, Se=14)["frames"]) @ lm.frontend_proj
    M.fill_cross_cache(lm, cfg, caches, enc)
    jfill = jax_M.fill_cross_cache(params, jcfg, jc, jnp.asarray(enc.numpy()))
    for i, layer in enumerate(caches):
        for key in ("ck", "cv"):
            _close(layer[key], jfill["groups"][i][key][0], f"{i} {key}")


@pytest.mark.parametrize("name", NAMES)
def test_params_to_jax_round_trips(name):
    jcfg, cfg, params, lm = _model(name)
    tree = params_to_jax(lm, cfg)
    assert set(tree) == set(params)
    _leaves_equal(tree, _np_tree(params),
                  lambda g, w, what: np.testing.assert_array_equal(
                      g, w, err_msg=what))
    again = params_from_jax(tree, cfg, device="cpu")
    for (n, a), (m, b) in zip(lm.state_dict().items(),
                              again.state_dict().items()):
        assert n == m and torch.equal(a, b), n


@pytest.mark.parametrize("name", NAMES)
def test_port_checkpoint_restores_in_the_reference(name, tmp_path):
    """`save_lm` writes ``frontend_proj``, ``encoder/groups/0/...`` and each
    layer's ``cross`` in the reference's stacked layout:
    `repro.training.checkpoint.restore` loads it against an `init_params`
    template, equal leaf for leaf, and `load_lm` reads it back bitwise."""
    jcfg, cfg, params, lm = _model(name)
    path = str(tmp_path / "lm.npz")
    CKPT.save_lm(path, lm, cfg)
    template = jax_M.init_params(jax.random.PRNGKey(11), jcfg)
    back = jax_ckpt.restore(path, template)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), back, params)
    again = CKPT.load_lm(path, cfg, device="cpu")
    for (n, a), (m, b) in zip(lm.state_dict().items(),
                              again.state_dict().items()):
        assert n == m and torch.equal(a, b), n


@pytest.mark.parametrize("name,dtype", [(VISION, "float32"),
                                        (AUDIO, "float32"),
                                        (AUDIO, "bfloat16")])
def test_reference_checkpoint_loads_in_the_port(name, dtype, tmp_path):
    jcfg = jax_reduced(jax_get_config(name), dtype=dtype)
    cfg = reduced(get_config(name), dtype=dtype)
    params = jax_M.init_params(jax.random.PRNGKey(5), jcfg)
    path = str(tmp_path / "ref.npz")
    jax_ckpt.save(path, params)
    lm = CKPT.load_lm(path, cfg, device="cpu")
    want = params_from_jax(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), params),
        cfg.replace(dtype="float32"), device="cpu")
    for (n, a), (m, b) in zip(lm.state_dict().items(),
                              want.state_dict().items()):
        assert n == m and a.dtype == getattr(torch, dtype), n
        assert torch.equal(a.float(), b), n


@pytest.mark.parametrize("name", NAMES)
def test_train_cli_runs_front_ends_on_cpu(name, tmp_path):
    """The reference's CLI batch: zero patches, or zero frames of seq // 2
    rows with the tokens cut to seq // 2; the checkpoint loads in both
    packages."""
    from repro_torch.launch import train
    ck = str(tmp_path / "lm.npz")
    state = {}
    hist = train.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--ckpt", ck], state=state)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    cfg = reduced(get_config(name))
    lm = CKPT.load_lm(ck, cfg, device="cpu")
    for (n, a), (m, b) in zip(lm.state_dict().items(),
                              state["lm"].state_dict().items()):
        assert n == m and torch.equal(a, b), n
    jcfg = jax_reduced(jax_get_config(name))
    back = jax_ckpt.restore(ck, jax_M.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    assert back["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)


#: (dtype, B, Sq, Sk, KV, G, hd): the cross shapes chip_smoke.py's phase 3
#: runs kernels 2 and 2b on (Sk 1,500 cut to 150 here), the recompute
#: path's Sq 1, Sk under one 64-row tile, and a GQA case
CROSS = [("float32", 2, 200, 150, 4, 1, 64),
         ("float32", 4, 1, 150, 4, 1, 64),
         ("float32", 1, 96, 40, 4, 1, 64),
         ("float32", 2, 33, 70, 2, 3, 80),
         ("bfloat16", 2, 200, 150, 4, 1, 64),
         ("bfloat16", 1, 96, 40, 4, 1, 64)]


@pytest.mark.parametrize("dtype,B,Sq,Sk,KV,G,hd", CROSS)
def test_plain_cross_attention_and_gradient_match_attend_ref(dtype, B, Sq, Sk,
                                                             KV, G, hd):
    """The plain versions of kernels 2 and 2b (what the CPU runs, and the
    card's yardstick) at Sq != Sk with no mask, through the wrapper,
    against `attend_ref` and `jax.vjp` of it.  f32 1e-4; bf16 1e-2 abs
    plus 2^-7 rel (both round to bf16 last, `test_torch_flash_bwd.py`)."""
    rng = np.random.default_rng(Sq * 7 + Sk)
    H = KV * G
    q, do = (rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
            for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(t).astype(jd) for t in (q, k, v)]
    jout, vjp = jax.vjp(lambda a, b, c: attend_ref(a, b, c, causal=False),
                        *jargs)
    jgrads = vjp(jnp.asarray(do).astype(jd))
    targs = [torch.from_numpy(t).to(td) for t in (q, k, v)]
    tdo = torch.from_numpy(do).to(td)
    out = fops.flash_attention(*targs, causal=False)
    assert torch.equal(out, flash_attention_reference(*targs, causal=False))
    grads = fops.flash_attention_bwd(*targs, tdo, causal=False)
    assert all(torch.equal(a, b) for a, b in zip(
        grads, flash_attention_bwd_plain(*targs, tdo, causal=False)))
    atol, rtol = (TOL, TOL) if dtype == "float32" else (1e-2, 2.0 ** -7)
    for what, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (jout, *jgrads)):
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=atol, rtol=rtol, err_msg=what)
