"""DeepSeek-V2 in the port against its plain float32 reference
(`tests/plain_deepseek_v2.py`) on the CPU, at small widths with the
query / key head dim apart from the value one and 8 experts in 4 groups:
YaRN, MLA's forward, the group-limited router, the held-block MoE layer,
two training steps with every leaf's gradient, the share of an
expert-parallel rank, and the registered entry's defaults.  Also the
grouped AdamW update against one group.  Seeded weights; f32 on both
sides, so the limits are float32 rounding's."""
import dataclasses
import math
import sys
import weakref
from pathlib import Path

import pytest
import torch

# the repository's root: the plain reference builds on the benchmark's
# `bench.plain`
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import plain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MLA_DENSE, MLA_MOE, ModelConfig  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as Ly  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402
from tests import plain_deepseek_v2 as R  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"}

#: a small DeepSeek-V2: 1 dense + 2 MoE layers, q / k 24 (16 + 8 RoPE) and
#: v 16, 8 router experts in 4 groups (top 2 groups, top 3 experts), this
#: rank holding experts 2 and 3
SMALL = {"hidden_size": 64, "vocab_size": 300, "num_hidden_layers": 3,
         "first_k_dense_replace": 1, "num_attention_heads": 4,
         "q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
         "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96,
         "moe_intermediate_size": 32, "n_shared_experts": 2,
         "num_experts_per_tok": 3, "n_group": 4, "topk_group": 2,
         "routed_scaling_factor": 16, "rope_theta": 10000,
         "rope_scaling": YARN, "rms_norm_eps": 1e-6, "aux_loss_alpha": 0.003,
         "n_routed_experts": 2, "published": {"n_routed_experts": 8},
         "deployment": {"first_expert": 2}}

OPT = {"lr": 2.4e-4, "warmup_steps": 1, "total_steps": 100, "b1": 0.9,
       "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0,
       "min_lr_ratio": 0.1}


def _c(**kw):
    c = dict(SMALL)
    c.update(kw)
    return c


def port_cfg(c):
    """The port's config of a plain-reference config dict."""
    L, dense = c["num_hidden_layers"], c["first_k_dense_replace"]
    return get_config("deepseek-v2-236b").replace(
        n_layers=L, d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_attention_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], pattern=(MLA_DENSE,), n_groups=dense,
        tail_pattern=(MLA_MOE,), n_tail_groups=L - dense,
        q_lora_rank=c["q_lora_rank"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_dim=c["qk_nope_head_dim"], qk_rope_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"],
        head_dim=c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
        n_experts=c["published"]["n_routed_experts"],
        experts_top_k=c["num_experts_per_tok"],
        n_shared_experts=c["n_shared_experts"],
        moe_d_ff=c["moe_intermediate_size"], moe_router="group_limited",
        moe_n_groups=c["n_group"], moe_topk_groups=c["topk_group"],
        moe_routed_scaling=float(c["routed_scaling_factor"]),
        moe_local_experts=c["n_routed_experts"],
        moe_first_expert=c["deployment"]["first_expert"],
        rope_scaling=tuple(sorted(c["rope_scaling"].items())),
        aux_weight=c["aux_loss_alpha"], dtype="float32", remat=True)


def _weights(c, seed=0):
    g = torch.Generator().manual_seed(seed)
    return plain.make_weights(R.lm_specs(c), g, "cpu")


def _port(c, w):
    cfg = port_cfg(c)
    lm = M.LM(cfg, "cpu")
    params = dict(lm.named_parameters())
    assert set(params) == set(w)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(w[n])
    return cfg, lm


def _batch(c, B=2, S=24, seed=5):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, c["vocab_size"], (B, S + 1), generator=g)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _close(a, b, tol=2e-5, what=""):
    err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))
    assert err < tol, (what, err)


# ---------------------------------------------------------------------------
# YaRN and MLA
# ---------------------------------------------------------------------------

def test_yarn_frequencies_and_scale_match_the_reference():
    c = _c(qk_rope_head_dim=64, qk_nope_head_dim=128)
    inv, mult, scale = R.rope_tables(c)
    got = torch.from_numpy(Ly.rope_frequencies(
        64, 10000.0, tuple(sorted(YARN.items()))))
    assert torch.allclose(got, inv, rtol=1e-6, atol=0)
    assert Ly.rope_mscale(tuple(sorted(YARN.items()))) == mult == 1.0
    cfg = port_cfg(c)
    assert A.mla_scale(cfg) == pytest.approx(scale, rel=1e-12)
    # DeepSeek-V2's numbers: (0.1 x 0.707 x ln 40 + 1)^2 / sqrt(192)
    assert scale == pytest.approx(0.11472, abs=5e-6)
    # the ramp: high-frequency pairs keep theta's, low-frequency ones / 40
    base = 1.0 / 10000.0 ** (torch.arange(0, 64, 2).float() / 64)
    assert torch.allclose(inv[:8], base[:8])
    assert torch.allclose(inv[-4:], base[-4:] / 40)
    # no scaling: the plain frequencies, scale 1/sqrt(dk)
    assert torch.allclose(torch.from_numpy(Ly.rope_frequencies(64, 1e4)),
                          base, rtol=1e-6, atol=0)


def test_mla_forward_matches_the_reference():
    c = _c()
    w = _weights(c, 1)
    cfg, lm = _port(c, w)
    x = torch.randn(2, 20, c["hidden_size"], generator=torch.Generator()
                    .manual_seed(2))
    pos = torch.arange(20)[None].expand(2, 20)
    got = A.mla_full(lm.blocks[0].attn, cfg, x, pos)
    want = R.mla(x, w, "blocks.0", pos, c, plain.Precision(),
                 R.rope_tables(c))
    _close(got, want, what="mla")


def test_flash_attention_cpu_path_takes_a_value_dim_and_scale():
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn(2, 9, 4, 24, generator=g) for _ in range(2))
    v = torch.randn(2, 9, 4, 16, generator=g)
    out = flash_attention(q, k, v, causal=True, scale=0.3)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.3
    s = s.masked_fill(~torch.ones(9, 9, dtype=torch.bool).tril(), -math.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    assert out.shape == (2, 9, 4, 16)
    _close(out, want, 1e-6)
    dq, dk, dv = flash_attention_bwd(q, k, v, torch.ones_like(out),
                                     causal=True, scale=0.3)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)


# ---------------------------------------------------------------------------
# the router and the MoE layer
# ---------------------------------------------------------------------------

def _tokens(c, B=2, S=16, seed=4):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, S, c["hidden_size"], generator=g)


def test_router_matches_the_reference():
    c = _c()
    w = _weights(c, 2)
    cfg, lm = _port(c, w)
    x = _tokens(c)
    tokens = x.reshape(-1, c["hidden_size"])
    gates, idx, aux = moe.route_grouped(lm.blocks[1].moe, cfg, tokens, 2)
    rg, ri, ra = R.route(tokens, w["blocks.1.moe.router"], c, 2)
    assert torch.equal(idx, ri)
    _close(gates, rg, 1e-6, "gates")
    _close(aux, ra, 1e-6, "aux")
    # the chosen experts lie in the best two groups of each token
    E, G = 8, 4
    s = torch.softmax(tokens @ w["blocks.1.moe.router"], -1)
    best = s.view(-1, G, E // G).amax(-1).argsort(-1, descending=True)[:, :2]
    assert ((idx // (E // G))[:, :, None] == best[:, None, :]).any(-1).all()
    # gates are the scores x 16, not renormalised
    _close(gates, s.gather(1, idx) * 16, 1e-6, "scaled")


def test_moe_layer_matches_the_reference():
    c = _c()
    w = _weights(c, 3)
    cfg, lm = _port(c, w)
    x = _tokens(c)
    moe.moe_ffn.dropped = 0
    y, aux = moe.moe_ffn(lm.blocks[2].moe, cfg, x)
    ry, ra = R.moe(x, w, "blocks.2", c, plain.Precision(), None)
    _close(y, ry, 2e-6, "moe")
    _close(aux, ra, 1e-6, "aux")
    assert int(moe.moe_ffn.dropped) == 0


def test_held_blocks_add_up_to_the_uncut_layer():
    """Each of the 4 ranks' blocks of 2 experts gives its share; with the
    shared experts counted once, the shares add up to the layer holding
    all 8 experts, as the reference computes it."""
    c_all = _c(n_routed_experts=8, deployment={"first_expert": 0})
    w = _weights(c_all, 4)
    x = _tokens(c_all)
    whole, _ = R.moe(x, w, "blocks.1", c_all, plain.Precision(), None)
    shared = R.swiglu(x.reshape(-1, 64), w["blocks.1.moe.shared.w_gate"],
                      w["blocks.1.moe.shared.w_up"],
                      w["blocks.1.moe.shared.w_down"],
                      plain.Precision()).view_as(x)
    total = shared.clone()
    for first in range(0, 8, 2):
        c = _c(n_routed_experts=2, deployment={"first_expert": first})
        wb = {k: v[first:first + 2] if k.endswith(
            ("moe.w_gate", "moe.w_up", "moe.w_down")) else v
            for k, v in w.items()}
        cfg, lm = _port(c, wb)
        y, _ = moe.moe_ffn(lm.blocks[1].moe, cfg, x)
        total = total + (y - shared)
    _close(total, whole, 2e-6, "shares")
    cfg, lm = _port(c_all, w)
    y, _ = moe.moe_ffn(lm.blocks[1].moe, cfg, x)
    _close(y, whole, 2e-6, "uncut")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_loss_and_every_gradient_match_the_reference():
    c = _c()
    w = _weights(c, 6)
    cfg, lm = _port(c, w)
    b = _batch(c)
    params = dict(lm.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    total, met = M.loss_fn(lm, cfg, b)
    total.backward()
    wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    rtotal, rnll = R.loss(wr, c, b["tokens"], b["labels"], plain.Precision())
    grads = dict(zip(wr, torch.autograd.grad(rtotal, list(wr.values()))))
    _close(total.detach(), rtotal.detach(), 1e-6, "total")
    _close(met["loss"].detach(), rnll.detach(), 1e-6, "nll")
    for n, p in params.items():
        _close(p.grad, grads[n], 2e-4, n)


def test_two_train_steps_match_the_reference():
    c = _c()
    w = _weights(c, 7)
    cfg, lm = _port(c, w)
    st = O.init(dict(lm.named_parameters()))
    step = make_train_step(cfg, O.OptConfig(**OPT))
    wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    adam = R.AdamW(wr, OPT)
    for i in range(2):
        b = _batch(c, seed=10 + i)
        m = step(lm, st, b)
        rtotal, rnll = R.loss(wr, c, b["tokens"], b["labels"],
                              plain.Precision())
        adam.step(wr, dict(zip(wr, torch.autograd.grad(
            rtotal, list(wr.values())))))
        _close(m["loss"], rnll.detach(), 1e-6, f"loss {i}")
    # each leaf's change, by its norm as the benchmark compares it: AdamW
    # turns a gradient's rounding into a full step where the gradient is
    # near 0, so single elements may differ more
    for n, p in st["master"].items():
        d, r = (p - w[n]).norm(), (wr[n].detach() - w[n]).norm()
        assert abs(float(d - r)) <= 1e-3 * float(r) + 1e-12, n


def test_registered_entry_keeps_its_defaults():
    """The new fields default to the reference's behaviour, so the
    registered deepseek-v2-236b (and the JAX parity tests) do not move."""
    cfg = get_config("deepseek-v2-236b")
    assert cfg.pattern == (MLA_MOE,) and cfg.n_groups == 60
    assert (cfg.n_experts, cfg.experts_top_k, cfg.n_shared_experts,
            cfg.moe_d_ff) == (160, 6, 2, 1536)
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    for f in ("moe_router", "moe_n_groups", "moe_topk_groups",
              "moe_routed_scaling", "moe_local_experts", "moe_first_expert",
              "aux_weight", "rope_scaling"):
        assert getattr(cfg, f) == defaults[f], f
    assert (defaults["moe_router"], defaults["moe_local_experts"],
            defaults["rope_scaling"], defaults["aux_weight"]) == \
        ("topk", 0, (), 0.01)


# ---------------------------------------------------------------------------
# AdamW over groups of leaves
# ---------------------------------------------------------------------------

def _opt_setup(seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = [(300, 40), (7,), (1000,), (64, 64), (5, 3, 11), (2048,)]
    params = {f"p{i}": torch.randn(s, generator=g).bfloat16()
              for i, s in enumerate(shapes)}
    grads = {k: torch.randn(v.shape, generator=g).bfloat16()
             for k, v in params.items()}
    return params, grads


def test_grouped_update_is_bitwise_one_group():
    opt = O.OptConfig(warmup_steps=1)
    runs = []
    for limit in (1 << 40, 4 * 1000, 1):
        params, grads = _opt_setup()
        st = O.init(params)
        for _ in range(3):
            O.update(opt, grads, st, params, group_bytes=limit)
        runs.append((params, st))
    for params, st in runs[1:]:
        for k in params:
            assert torch.equal(params[k], runs[0][0][k])
            for s in ("m", "v", "master"):
                assert torch.equal(st[s][k], runs[0][1][s][k])
    names = list(runs[0][0])
    sizes = {n: 4 * runs[0][0][n].numel() for n in names}
    groups = O.groups(names, runs[0][0], 4 * 1000)
    assert [n for g in groups for n in g] == names
    assert all(sum(sizes[n] for n in g) <= 4 * 1000 or len(g) == 1
               for g in groups)


class _LiveBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """The peak of bytes held by tensors the ops under it made and that
    are still alive."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {id(a) for a in torch.utils._pytree.tree_leaves(
            (args, kwargs)) if isinstance(a, torch.Tensor)}
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and id(t) not in inputs:
                n = t.numel() * t.element_size()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)
        return out

    def _free(self, n):
        self.live -= n


def test_grouped_update_bounds_its_temporaries():
    """Under a bound of one leaf's bytes, the temporaries' peak is that of
    the largest group, not of all the leaves together."""
    opt = O.OptConfig(warmup_steps=1)
    peaks = {}
    for limit in (1 << 40, 1):
        params, grads = _opt_setup(1)
        st = O.init(params)
        with _LiveBytes() as mode:
            O.update(opt, grads, st, params, group_bytes=limit)
        peaks[limit] = mode.peak
    biggest = max(4 * p.numel() for p in params.values())
    total = sum(4 * p.numel() for p in params.values())
    assert peaks[1] < peaks[1 << 40]
    assert peaks[1] <= 8 * biggest + 1024
    assert peaks[1 << 40] >= 4 * total
