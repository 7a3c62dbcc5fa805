"""The port's other text families (qwen1.5-32b, starcoder2-15b, the MoE
llama4-maverick, the MLA + MoE deepseek-v2, the hybrid zamba2-7b with its
shared attention block) against `repro.models.model` at their reduced
configs, f32, with the reference's weights carried by `params_from_jax`
and seeded numpy inputs; the MoE dispatch, MLA's two decodes, zamba2's
long-mode window, and checkpoints that cross between the packages.

Tolerance 1e-4 (abs and rel), as `test_torch_models.py`: the frameworks
sum the matmuls and softmaxes in other orders, which moves f32 results by
~1e-6 a layer; a wrong mask, rope layout, routing or capacity drop moves
them by O(1e-2) or more."""
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
from repro.models import moe as jax_moe  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import SSM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.training import checkpoint as CKPT  # noqa: E402

TOL = 1e-4
NEW = ("qwen1.5-32b", "starcoder2-15b", "llama4-maverick-400b-a17b",
       "deepseek-v2-236b", "zamba2-7b")
#: family -> (arch, overrides of `reduced`): zamba2 also with one tail group
FAMILIES = {**{n: (n, {}) for n in NEW},
            "zamba2-7b+tail": ("zamba2-7b",
                               dict(tail_pattern=(SSM,), n_tail_groups=1))}


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
def _family(key):
    name, over = FAMILIES[key]
    jcfg = jax_reduced(jax_get_config(name), **over)
    cfg = reduced(get_config(name), **over)
    assert_same_config(jcfg, cfg)
    params = jax_M.init_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, cfg, params, params_from_jax(_np_tree(params), cfg,
                                              device="cpu")


def _batch(cfg, B=2, S=24, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=what)


def test_new_configs_are_copies_of_the_reference():
    for name in NEW:
        assert_same_config(jax_get_config(name),
                           get_config(name))
        assert_same_config(jax_reduced(jax_get_config(name)),
                           reduced(get_config(name)))


def test_moe_router_stays_f32_in_a_bf16_model():
    jcfg = jax_reduced(jax_get_config("deepseek-v2-236b"), dtype="bfloat16")
    tree = _np_tree(jax_M.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = reduced(get_config("deepseek-v2-236b"), dtype="bfloat16")
    lm = params_from_jax(tree, cfg, device="cpu")
    m = lm.blocks[0].moe
    assert m.router.dtype == torch.float32
    assert m.w_gate.dtype == m.shared.w_up.dtype == torch.bfloat16
    assert lm.blocks[0].attn.w_dkv.dtype == torch.bfloat16


@pytest.mark.parametrize("key", list(FAMILIES))
def test_family_forward_loss_and_gradients_match_reference(key):
    """Logits and the aux loss of `forward`; the total loss of `loss_fn`
    and the gradient of every leaf against jax.value_and_grad, compared in
    the reference's tree (`params_to_jax` of the port's gradients)."""
    jcfg, cfg, params, lm0 = _family(key)
    lm = copy.deepcopy(lm0)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jaux = jax.jit(lambda p: jax_M.forward(
        p, jcfg, {"tokens": jb["tokens"]}))(params)
    with torch.no_grad():
        tl, aux = M.forward(lm, cfg, tb)
    _close(tl, jl, "logits")
    _close(aux, jaux, "aux")
    if cfg.n_experts:
        assert float(aux) > 0
    (jtot, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_M.loss_fn(p, jcfg, jb), has_aux=True))(params)
    lm.requires_grad_(True)
    tot, met = M.loss_fn(lm, cfg, tb)
    tot.backward()
    _close(tot.detach(), jtot, "total loss")
    _close(met["aux_loss"].detach(), jmet["aux_loss"], "aux loss")
    grads = {n: p.grad for n, p in lm.named_parameters()}
    assert all(g is not None for g in grads.values())
    got = params_to_jax(grads, cfg)
    want = _np_tree(jg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = functools.reduce(lambda t, p: t[getattr(p, "key",
                                                    getattr(p, "idx", p))],
                             path, got)
        _close(g, w, jax.tree_util.keystr(path))


def _decode_jax(params, cfg, toks, pos, cache_len):
    caches = jax_M.init_caches(cfg, toks.shape[1], cache_len)
    step = jax.jit(lambda p, c, t, q: jax_M.decode_step(p, cfg, c, t, q))
    out = []
    for t in range(toks.shape[0]):
        logits, caches = step(params, caches, jnp.asarray(toks[t][:, None]),
                              jnp.asarray(pos[t]))
        out.append(np.asarray(logits))
    return np.stack(out)


def _decode_port(lm, cfg, toks, pos, cache_len):
    caches = M.init_caches(cfg, toks.shape[1], cache_len, "cpu")
    out = []
    for t in range(toks.shape[0]):
        logits, caches = M.decode_step(lm, cfg, caches,
                                       torch.from_numpy(toks[t][:, None]),
                                       torch.from_numpy(pos[t]))
        out.append(logits.numpy())
    return np.stack(out)


@pytest.mark.parametrize("key", list(FAMILIES))
def test_family_teacher_forced_decode_matches_reference(key):
    """Ten decode steps of two slots at their own positions (slot 1 three
    positions ahead) against the reference's `decode_step`: GQA and MLA
    caches, MoE over the slots (T = 2), the shared block's ring cache and
    the SSM state."""
    jcfg, cfg, params, lm = _family(key)
    rng = np.random.default_rng(6)
    steps, cache_len = 10, 16
    toks = rng.integers(1, cfg.vocab_size, size=(steps, 2)).astype(np.int32)
    pos = (np.arange(steps)[:, None] + np.array([0, 3])[None]).astype(
        np.int32)
    _close(_decode_port(lm, cfg, toks, pos, cache_len),
           _decode_jax(params, jcfg, toks, pos, cache_len), key)


@pytest.mark.parametrize("cf,T", [(0.3, 40), (1.25, 7), (0.5, 64)])
def test_moe_dispatch_drops_as_the_reference(cf, T):
    """`dispatch_indices` against the reference's `_dispatch_indices` on
    skewed expert choices at a capacity that drops (C from `capacity`, at
    least 8 slots: cf 0.3 and 0.5 drop)."""
    E, k = 4, 2
    rng = np.random.default_rng(int(cf * 10) + T)
    flat = rng.choice(E, size=T * k, p=[0.55, 0.25, 0.15, 0.05])
    C = moe.capacity(T, k, E, cf)
    assert C == jax_moe._capacity(T, k, E, cf)
    js, jk = jax_moe._dispatch_indices(jnp.asarray(flat, jnp.int32), E, C)
    ts, tk = moe.dispatch_indices(torch.from_numpy(flat), E, C)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if cf < 1:
        assert (~tk).sum() > 0


def test_moe_route_breaks_ties_toward_the_lower_expert():
    """Router-logit ties (equal router columns) go to the lower expert id,
    as `lax.top_k` breaks them; gates and aux as the reference's."""
    jcfg, cfg, params, lm = _family("llama4-maverick-400b-a17b")
    cfg2 = cfg.replace(experts_top_k=2)
    p = copy.deepcopy(lm.blocks[1].moe)
    with torch.no_grad():
        p.router[:, 2] = p.router[:, 0]
        p.router[:, 3] = p.router[:, 1]
    x = np.random.default_rng(0).normal(size=(9, cfg.d_model)).astype(
        np.float32)
    g, idx, aux = moe.route(p, cfg2, torch.from_numpy(x))
    jp = {"router": jnp.asarray(p.router.numpy())}
    jg, jidx, jaux = jax_moe._route(jp, jcfg.replace(experts_top_k=2),
                                    jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # columns 0 = 2 and 1 = 3: every row's two best logits tie
    assert bool((g[:, 0] == g[:, 1]).all())
    assert bool((idx[:, 0] < idx[:, 1]).all())
    _close(g, jg)
    _close(aux, jaux)


def test_moe_counts_dropped_slots():
    jcfg, cfg, params, lm = _family("deepseek-v2-236b")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32))
    moe.moe_ffn.dropped = moe.moe_ffn.routed = 0
    with torch.no_grad():
        moe.moe_ffn(lm.blocks[0].moe, cfg.replace(capacity_factor=0.25), x)
    assert int(moe.moe_ffn.routed) == 64 * cfg.experts_top_k
    assert 0 < int(moe.moe_ffn.dropped) < 64 * cfg.experts_top_k
    moe.moe_ffn.dropped = moe.moe_ffn.routed = 0


def test_mla_absorbed_decode_matches_naive_and_caches_are_latent():
    jcfg, cfg, params, lm = _family("deepseek-v2-236b")
    caches = M.init_caches(cfg, 2, 16, "cpu")
    assert caches[0]["c"].shape == (2, 16, cfg.kv_lora_rank)
    assert caches[0]["kr"].shape == (2, 16, cfg.qk_rope_dim)
    assert set(caches[0]) == {"c", "kr"}
    rng = np.random.default_rng(8)
    toks = rng.integers(1, cfg.vocab_size, size=(12, 2)).astype(np.int32)
    pos = (np.arange(12)[:, None] + np.array([0, 2])[None]).astype(np.int32)
    absorbed = _decode_port(lm, cfg, toks, pos, 16)
    naive = _decode_port(lm, cfg.replace(mla_naive_decode=True), toks, pos,
                         16)
    _close(absorbed, naive)


def test_zamba2_long_mode_shared_window_matches_reference():
    """``long_mode``: the shared block attends within its window (64 in
    the reduced config) over S = 80 > 64 tokens, and its decode cache is a
    ring of the window's size."""
    jcfg, cfg, params, lm = _family("zamba2-7b")
    assert cfg.shared_attn_window == 64
    toks = _batch(cfg, B=1, S=80, seed=9)["tokens"]
    jl, _ = jax.jit(lambda p: jax_M.forward(
        p, jcfg, {"tokens": jnp.asarray(toks)}, long_mode=True))(params)
    with torch.no_grad():
        tl, _ = M.forward(lm, cfg, {"tokens": torch.from_numpy(toks)},
                          long_mode=True)
        full, _ = M.forward(lm, cfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    assert float((tl[:, 70:] - full[:, 70:]).abs().max()) > 1e-3
    assert float((tl[:, :64] - full[:, :64]).abs().max()) < 1e-5
    short = M.init_caches(cfg, 1, 200, "cpu", long_mode=True)
    assert short[1]["k"].shape[1] == 64
    assert M.init_caches(cfg, 1, 200, "cpu")[1]["k"].shape[1] == 200
    jc = jax_M.init_caches(jcfg, 1, 200, long_mode=True)
    assert jc["groups"][1]["k"].shape[2] == 64


@pytest.mark.parametrize("key", ["zamba2-7b+tail", "deepseek-v2-236b"])
def test_port_checkpoint_restores_in_the_reference(key, tmp_path):
    """`save_lm` writes the reference's tree: `repro.training.checkpoint.
    restore` loads it against an `init_params` template, equal leaf for
    leaf (in f32 and into a bf16 template), and `load_lm` reads it back
    bitwise."""
    jcfg, cfg, params, lm = _family(key)
    path = str(tmp_path / "lm.npz")
    CKPT.save_lm(path, lm, cfg)
    template = jax_M.init_params(jax.random.PRNGKey(11), jcfg)
    back = jax_ckpt.restore(path, template)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), back, params)
    bf = jax_ckpt.restore(path, jax.tree.map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
        template))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(jnp.asarray(b).astype(jnp.bfloat16))),
        bf, params)
    again = CKPT.load_lm(path, cfg, device="cpu")
    for (n, a), (m, b) in zip(lm.state_dict().items(),
                              again.state_dict().items()):
        assert n == m and torch.equal(a, b), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_loads_in_the_port(dtype, tmp_path):
    """A checkpoint the reference writes loads in the port: f32 leaves, and
    bf16 leaves, which `np.load` returns as raw 2-byte voids (``|V2``)."""
    key = "zamba2-7b+tail"
    name, over = FAMILIES[key]
    jcfg = jax_reduced(jax_get_config(name), dtype=dtype, **over)
    cfg = reduced(get_config(name), dtype=dtype, **over)
    params = jax_M.init_params(jax.random.PRNGKey(5), jcfg)
    path = str(tmp_path / "ref.npz")
    jax_ckpt.save(path, params)
    kinds = {np.load(path)[k].dtype.kind for k in np.load(path).files}
    assert kinds == ({"f"} if dtype == "float32" else {"f", "V"})
    lm = CKPT.load_lm(path, cfg, device="cpu")
    want = params_from_jax(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), params),
        cfg.replace(dtype="float32"), device="cpu")
    for (n, a), (m, b) in zip(lm.state_dict().items(),
                              want.state_dict().items()):
        assert n == m and a.dtype == (torch.float32 if n.endswith(
            ("router", "A_log", "D", "dt_bias")) else getattr(torch, dtype))
        assert torch.equal(a.float(), b), n


@pytest.mark.parametrize("name", NEW)
def test_train_cli_runs_each_new_architecture_on_cpu(name, tmp_path):
    from repro_torch.launch import train
    ck = str(tmp_path / "lm.npz")
    hist = train.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--ckpt", ck])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    if get_config(name).n_experts:
        assert all(h["aux_loss"] > 0 for h in hist)
    cfg = reduced(get_config(name))
    lm = CKPT.load_lm(ck, cfg, device="cpu")
    assert sum(p.numel() for p in lm.parameters()) > 0


@pytest.mark.parametrize("name", NEW)
def test_engine_serves_each_family_as_each_request_alone(name):
    """A `ServingEngine` of the reduced config serves four prompts in one
    batch of slots; each request's greedy tokens equal those it gets alone
    in a fresh engine (MoE over the slots stays under its capacity floor of
    8; zamba2's SSM state is per slot)."""
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = reduced(get_config(name))
    lm = M.init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, 5 + i).astype(np.int32)
               for i in range(4)]

    def serve(ps):
        eng = ServingEngine(cfg, copy.deepcopy(lm), max_slots=4,
                            cache_len=32, device="cpu")
        reqs = [Request(uid=i, prompt_tokens=p, max_new_tokens=4)
                for i, p in enumerate(ps)]
        eng.run_until_drained(reqs)
        return [r.output_tokens for r in reqs]
    together = serve(prompts)
    assert all(len(t) == 4 for t in together)
    assert together == [serve([p])[0] for p in prompts]
