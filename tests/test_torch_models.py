"""Port models (`repro_torch.models`, `repro_torch.serving.encoder`)
against the JAX package with the same weights: JAX params are converted
by `params_from_jax`, inputs are made with numpy, everything runs in f32 on
the CPU.  Tolerance 1e-4: the two frameworks sum the d=256..768 matmuls
and the softmax in different orders, which moves f32 results by ~1e-6
per layer; 1e-4 keeps two orders of margin without hiding a wrong
mask, rope layout or norm (those move values by O(1))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import model as jax_M  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-4


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


def test_configs_are_copies_of_the_reference():
    for name in ("qwen3-4b", "h2o-danube-1.8b"):
        assert_same_config(jax_get_config(name),
                           get_config(name))
        assert_same_config(jax_reduced(jax_get_config(name)),
                           reduced(get_config(name)))


def test_rmsnorm_rope_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    norm = layers.RMSNorm(64, torch.float32, "cpu")
    norm.scale.data = torch.from_numpy(scale)
    np.testing.assert_allclose(
        layers.rmsnorm(norm, torch.from_numpy(x)).numpy(),
        np.asarray(jax_layers.rmsnorm({"scale": scale}, x)), atol=TOL)
    pos = rng.integers(0, 5000, size=(2, 5))
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta).numpy(),
            np.asarray(jax_layers.apply_rope(x, jnp.asarray(pos), theta)),
            atol=TOL)
    jp = jax_layers.mlp_init(jax.random.PRNGKey(1), 64, 96, jnp.float32)
    mlp = layers.MLP(64, 96, torch.float32, "cpu")
    for name, w in _np_tree(jp).items():
        getattr(mlp, name).data = torch.from_numpy(w.copy())
    xm = rng.normal(size=(3, 64)).astype(np.float32)
    np.testing.assert_allclose(layers.mlp(mlp, torch.from_numpy(xm)).numpy(),
                               np.asarray(jax_layers.mlp(jp, xm)), atol=TOL)


def test_dense_init_is_truncated_fan_in():
    w = layers.param((512, 256), torch.float32, "cpu")
    layers.dense_init_(w, torch.Generator().manual_seed(0))
    std = 1.0 / np.sqrt(512)
    assert w.abs().max() <= 2 * std + 1e-7
    assert abs(float(w.std()) / std - 0.88) < 0.02   # std of N(0,1) on [-2,2]


def test_params_from_jax_unstacks_groups_in_layer_order():
    cfg = jax_reduced(jax_get_config("qwen3-4b"))
    tree = _np_tree(jax_M.init_params(jax.random.PRNGKey(0), cfg))
    lm = params_from_jax(tree, reduced(get_config("qwen3-4b")), device="cpu")
    g = tree["stack"]["groups"]
    # reduced configs run a pattern of two blocks in one group
    np.testing.assert_array_equal(lm.blocks[0].attn.wq.numpy(),
                                  g[0]["attn"]["wq"][0])
    np.testing.assert_array_equal(lm.blocks[1].mlp.w_down.numpy(),
                                  g[1]["mlp"]["w_down"][0])
    np.testing.assert_array_equal(lm.blocks[1].attn.k_norm.scale.numpy(),
                                  g[1]["attn"]["k_norm"]["scale"][0])


def test_encoder_embeddings_match_reference(monkeypatch):
    from repro.configs.base import ATTN_DENSE, ModelConfig
    from repro.serving import encoder as jax_enc
    from repro_torch.serving import encoder as torch_enc
    from repro_torch.serving.encoder import (ENCODER_CFG, QueryEncoder,
                                             hash_tokenize)
    texts = ["python programming question 3", "world history", "",
             "algebra proofs request number 17 " * 20, "Poetry  Writing"]
    for t in texts:
        np.testing.assert_array_equal(hash_tokenize(t),
                                      jax_enc.hash_tokenize(t))
    # the reference encoder's own params: encoder.py builds them from
    # PRNGKey(7) with this config
    jcfg = ModelConfig(
        name="query-encoder", arch_type="dense", n_layers=2, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=1536, vocab_size=8192,
        pattern=(ATTN_DENSE,), n_groups=2, dtype="float32", remat=False)
    tree = _np_tree(jax_M.init_params(jax.random.PRNGKey(7), jcfg))
    enc = QueryEncoder(params_from_jax(tree, ENCODER_CFG, device="cpu"),
                       device="cpu")
    # two texts per encoder call, so the chunked concat path is covered
    monkeypatch.setattr(torch_enc, "_CHUNK", 2)
    got = enc.embed_texts(texts)
    want = jax_enc.embed_texts(texts)
    assert got.shape == want.shape == (len(texts), 768)
    np.testing.assert_allclose(got, want, atol=TOL)


def _teacher_forced_logits_port(lm, cfg, toks, pos, cache_len):
    caches = M.init_caches(cfg, toks.shape[1], cache_len, "cpu")
    out = []
    for t in range(toks.shape[0]):
        logits, caches = M.decode_step(
            lm, cfg, caches, torch.from_numpy(toks[t][:, None]).long(),
            torch.from_numpy(pos[t]))
        out.append(logits.numpy())
    return np.stack(out)


def _teacher_forced_logits_jax(params, cfg, toks, pos, cache_len):
    caches = jax_M.init_caches(cfg, toks.shape[1], cache_len)
    step = jax.jit(lambda p, c, t, q: jax_M.decode_step(p, cfg, c, t, q))
    out = []
    for t in range(toks.shape[0]):
        logits, caches = step(params, caches, jnp.asarray(toks[t][:, None]),
                              jnp.asarray(pos[t]))
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.mark.parametrize("name,cache_len,steps", [
    ("qwen3-4b", 48, 40),
    # reduced danube: window 64, cache 96 -> a ring of S = 64 slots written
    # at pos % 64; 80 steps run every slot past position 64
    ("h2o-danube-1.8b", 96, 80),
])
def test_teacher_forced_decode_logits_match_reference(name, cache_len, steps):
    jcfg = jax_reduced(jax_get_config(name))
    cfg = reduced(get_config(name))
    params = jax_M.init_params(jax.random.PRNGKey(3), jcfg)
    lm = params_from_jax(_np_tree(params), cfg, device="cpu")
    rng = np.random.default_rng(5)
    B = 3
    toks = rng.integers(1, cfg.vocab_size, size=(steps, B)).astype(np.int32)
    # per-slot positions: slots start at different offsets
    pos = (np.arange(steps)[:, None] + np.array([0, 2, 9])[None]).astype(
        np.int32)
    if cfg.sliding_window == 0:
        pos = np.minimum(pos, cache_len - 1)
    want = _teacher_forced_logits_jax(params, jcfg, toks, pos, cache_len)
    got = _teacher_forced_logits_port(lm, cfg, toks, pos, cache_len)
    if cfg.sliding_window:
        assert M.init_caches(cfg, 1, cache_len, "cpu")[0]["k"].shape[1] == 64
        assert pos.max() > 64
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# mamba2-370m (Mamba-2 SSD layers)
# ---------------------------------------------------------------------------

def _mamba(seed=3):
    jcfg = jax_reduced(jax_get_config("mamba2-370m"))
    cfg = reduced(get_config("mamba2-370m"))
    params = jax_M.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, params, params_from_jax(_np_tree(params), cfg,
                                              device="cpu")


def test_mamba_config_is_a_copy_and_keeps_f32_ssm_leaves():
    assert_same_config(jax_get_config("mamba2-370m"),
                       get_config("mamba2-370m"))
    assert_same_config(jax_reduced(jax_get_config("mamba2-370m")),
                       reduced(get_config("mamba2-370m")))
    cfg = get_config("mamba2-370m").replace(n_layers=1, n_groups=1)
    lm = M.LM(cfg, device="meta")
    ssm = lm.blocks[0].ssm
    assert (cfg.d_inner, cfg.ssm_heads, cfg.ssm_state) == (2048, 32, 128)
    assert ssm.in_proj.shape == (1024, 2 * 2048 + 2 * 128 + 32)
    assert ssm.conv_w.shape == (4, 2048 + 2 * 128)
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(ssm, name).dtype == torch.float32
    assert ssm.in_proj.dtype == ssm.norm.scale.dtype == torch.bfloat16
    # a bf16 JAX tree converts leaf by leaf, dtypes kept
    jcfg = jax_reduced(jax_get_config("mamba2-370m"), dtype="bfloat16")
    tree = _np_tree(jax_M.init_params(jax.random.PRNGKey(0), jcfg))
    lm = params_from_jax(tree, reduced(get_config("mamba2-370m"),
                                       dtype="bfloat16"), device="cpu")
    blk = lm.blocks[1].ssm
    assert blk.A_log.dtype == torch.float32
    assert blk.in_proj.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        blk.conv_w.float().numpy(),
        tree["stack"]["groups"][1]["ssm"]["conv_w"][0].astype(np.float32))


def _lm_batch(cfg, B=2, S=40, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                       # ignored positions
    return {"tokens": toks[:, :-1], "labels": labels}


def test_mamba_forward_loss_and_gradients_match_reference():
    """reduced(mamba2-370m): two SSD layers (state 16, heads of 32, chunk
    16), S = 40 so the last chunk is padded.  Logits, loss and the gradient
    of every parameter against jax.value_and_grad of the reference's
    loss_fn (the SSD gradient is the port's explicit backward on the CPU)."""
    jcfg, cfg, params, lm = _mamba()
    batch = _lm_batch(cfg)
    jl, _ = jax_M.forward(params, jcfg, {"tokens": jnp.asarray(
        batch["tokens"])})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tl, aux = M.forward(lm, cfg, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    assert float(aux) == 0.0

    (jtot, jmet), jg = jax.value_and_grad(
        lambda p: jax_M.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()}),
        has_aux=True)(params)
    lm.requires_grad_(True)
    tot, met = M.loss_fn(lm, cfg, tb)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), atol=TOL,
                               rtol=TOL)
    assert float(met["tokens"]) == float(jmet["tokens"]) == 2 * 40 - 3
    want = params_from_jax(_np_tree(jg), cfg, device="cpu")
    got = dict(lm.named_parameters())
    for name, w in want.named_parameters():
        g = got[name].grad
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_mamba_decode_matches_forward():
    """The port's recurrence (decode) against its own chunked forward, as
    the reference's test_models checks its own (rtol 1e-2, atol 5e-3)."""
    _, cfg, _, lm = _mamba(seed=5)
    batch = _lm_batch(cfg, B=2, S=24, seed=6)
    toks = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        full = M.forward(lm, cfg, {"tokens": toks})[0].numpy()
    caches = M.init_caches(cfg, 2, 32, "cpu")
    steps = []
    for t in range(toks.shape[1]):
        logits, caches = M.decode_step(lm, cfg, caches, toks[:, t:t + 1],
                                       torch.full((2,), t))
        steps.append(logits.numpy())
    np.testing.assert_allclose(np.stack(steps, 1), full, rtol=1e-2,
                               atol=5e-3)


@pytest.mark.parametrize("name", ["internvl2-76b", "seamless-m4t-medium"])
def test_unported_layer_specs_raise(name):
    """The vision and audio front ends are ported: their configs, built
    with the port's dataclass from the reference's values, give their
    dense attention specs (the decoder's of an encoder-decoder, whose
    layers hold cross attention) and a model with the front end's leaves;
    a layer spec outside the ported set is still refused, and so is cross
    attention on a layer other than GQA attention."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.transformer import layer_specs
    cfg = reduced(get_config("mamba2-370m"))
    assert layer_specs(cfg) == [("ssm", "none")] * 2
    with pytest.raises(NotImplementedError, match="not ported"):
        layer_specs(cfg.replace(pattern=(("attn", "none"),)))
    front = ModelConfig(**vars(jax_reduced(jax_get_config(name))))
    assert layer_specs(front) == [("attn", "dense")] * 2
    lm = M.LM(front, device="meta")
    assert lm.frontend_proj.shape == (front.frontend_dim, front.d_model)
    assert hasattr(lm, "encoder") == front.is_encoder_decoder
    assert all(hasattr(b, "cross") == front.is_encoder_decoder
               for b in lm.blocks)
    with pytest.raises(NotImplementedError, match="not ported"):
        layer_specs(front.replace(pattern=(("attn", "none"),)))
    with pytest.raises(NotImplementedError, match="not ported"):
        layer_specs(front.replace(pattern=(("ssm", "none"),),
                                  encoder_layers=1))
