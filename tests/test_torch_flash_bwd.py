"""The plain version of the flash attention backward (kernel 2b,
`flash_attention_bwd_plain`, the yardstick of `bwd_kernel.cu` on the card)
against `jax.grad` of the reference's `attend_ref`, which is what the JAX
trainer differentiates: dQ, dK and dV for causal, windowed (window < S) and
non-causal attention, GQA with G = 1, 5 and 12, head dims 64, 80, 112 and
128, S not a multiple of the kernels' 64-row tiles, f32 and bf16.

Tolerances: f32 1e-4 (abs and rel): the two frameworks sum the products
in other orders (~1e-6).  bf16: both compute in f32 and round to bf16
last, so two results may sit a bf16 step apart: 1e-2 abs plus 2^-7 rel.

The kernel's bf16 rounding is emulated here too (`_emulate_kernel`): P
and dS enter their products as two bf16 terms, every sum is f32, D comes
from the f32 output; that emulation is held against the f32 gradient
under the card's bf16 limit, and one rounding of P and dS is shown to
miss it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.attention import attend_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_reference)

#: (dtype, B, S, KV, G, hd, causal, window): the cases chip_smoke.py's
#: phase 3 runs kernel 2b on, at smaller B and S
CASES = [
    ("float32", 2, 70, 2, 1, 64, True, 0),
    ("float32", 1, 100, 1, 5, 80, True, 32),
    ("float32", 1, 70, 1, 12, 112, False, 0),
    ("float32", 1, 130, 2, 1, 128, True, 48),
    ("float32", 1, 64, 1, 12, 128, True, 0),
    ("float32", 1, 90, 1, 5, 112, True, 20),
    ("bfloat16", 2, 70, 2, 1, 64, True, 0),
    ("bfloat16", 1, 100, 1, 5, 80, False, 0),
    ("bfloat16", 1, 70, 1, 12, 112, True, 16),
    ("bfloat16", 1, 130, 1, 5, 128, True, 0),
]


def _data(dtype, B, S, KV, G, hd, seed):
    rng = np.random.default_rng(seed)
    H = KV * G
    q, do = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _jax_grads(q, k, v, do, dtype, causal, window):
    jd = getattr(jnp, dtype)
    args = [jnp.asarray(t).astype(jd) for t in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b, c: attend_ref(a, b, c, causal=causal,
                                                window=window), *args)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do).astype(jd))]


@pytest.mark.parametrize("dtype,B,S,KV,G,hd,causal,window", CASES)
def test_plain_backward_matches_jax_grad_of_attend_ref(dtype, B, S, KV, G,
                                                       hd, causal, window):
    q, k, v, do = _data(dtype, B, S, KV, G, hd, seed=S + hd + G)
    td = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(t).to(td) for t in (q, k, v, do))
    got = flash_attention_bwd_plain(tq, tk, tv, tdo, causal=causal,
                                    window=window)
    want = _jax_grads(q, k, v, do, dtype, causal, window)
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (1e-2, 2.0 ** -7)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (tq, tk, tv)):
        assert g.dtype == td and g.shape == t.shape
        np.testing.assert_allclose(g.float().numpy(), w, atol=atol,
                                   rtol=rtol, err_msg=name)
    # the gradients are not trivially small: the mask and the GQA sums
    # matter at these tolerances
    assert float(got[1].float().abs().max()) > 0.1


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    """`flash_attention_bwd` on CPU tensors returns the plain version, and
    autograd through `flash_attention` on the CPU gives the same
    gradients; the forward's log-sum-exp is not needed there."""
    q, k, v, do = _data("float32", 1, 70, 2, 5, 80, seed=3)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    n0 = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(tq, tk, tv, tdo, causal=True, window=24)
    assert ops.flash_attention_bwd.launches == n0
    want = flash_attention_bwd_plain(tq, tk, tv, tdo, causal=True, window=24)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    a, b, c = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    out = ops.flash_attention(a, b, c, causal=True, window=24)
    assert torch.equal(out.detach(), flash_attention_reference(
        tq, tk, tv, causal=True, window=24))
    out.backward(tdo)
    for t, w in zip((a, b, c), want):
        torch.testing.assert_close(t.grad, w, atol=1e-6, rtol=1e-6)


def test_cuda_only_arguments_are_checked():
    """On the card the backward needs the forward's out and lse; head dims
    outside the kernels' set are refused before any launch."""
    assert ops.HEAD_DIMS == (64, 80, 112, 128)
    from repro_torch.kernels.decode_attention import ops as dops
    assert dops.HEAD_DIMS == ops.HEAD_DIMS
    z = torch.zeros((1, 4, 2, 96), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(z, z, z)


def _emulate_kernel(q, k, v, do, causal, window, split=True):
    """The bf16 kernel's arithmetic in plain torch: S and dP from the bf16
    inputs summed in f32, P = exp(S - lse) in f32, D = rowsum(dO o O) from
    the f32 O, dS = P (dP - D) in f32; P and dS rounded to bf16 where they
    enter dV = P^T dO, dK = c dS^T Q and dQ = c dS K, as hi + lo bf16 terms
    (``split``) or once; f32 sums, outputs rounded to bf16."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, hd)
    dof = do.float().reshape(B, S, KV, H // KV, hd)
    kf, vf = k.float(), v.float()
    c = 1.0 / np.sqrt(hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * c
    i = torch.arange(S)
    live = torch.ones(S, S, dtype=torch.bool)
    if causal:
        live &= i[:, None] >= i[None, :]
    if window:
        live &= i[:, None] - i[None, :] < window
    s = s.masked_fill(~live, float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    o = torch.einsum("bkgqs,bskd->bkgqd", p, vf)
    d = (o * dof.permute(0, 2, 3, 1, 4)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bqkgd,bskd->bkgqs", dof, vf) - d)

    def rounded(x):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float() if split else hi
    p, ds = rounded(p), rounded(ds)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * c
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(q.shape) * c
    return [t.bfloat16() for t in (dq, dk, dv)]


def _bf16_limit_ratio(got, want):
    """Largest |got - want| over the card's bf16 limit, 1e-2 or bf16's own
    rounding 2^-8 |want| + 2e-5 where larger (chip_smoke.py's
    `grad_err`); <= 1 passes."""
    d = (got.float() - want).abs()
    lim = torch.maximum(torch.full_like(want, 1e-2),
                        want.abs() * 2.0 ** -8 + 2e-5)
    return float((d / lim).max())


def _bf16_inputs(B, S, KV, G, hd):
    q, k, v, do = _data("bfloat16", B, S, KV, G, hd, seed=S + hd + G)
    return [torch.from_numpy(t).bfloat16() for t in (q, k, v, do)]


@pytest.mark.parametrize("B,S,KV,G,hd,causal,window", [
    (1, 1024, 2, 4, 80, True, 0),
    (1, 512, 1, 12, 128, True, 100),
    (1, 333, 2, 4, 112, True, 100),
    (2, 130, 2, 5, 112, True, 0),
])
def test_kernel_rounding_emulation_within_bf16_limit(B, S, KV, G, hd, causal,
                                                     window):
    """The bf16 kernel's rounding (P and dS as hi + lo bf16 terms, f32
    sums, D from the f32 output) against the f32 gradient of the same
    bf16 values: within the card's bf16 limit for dQ, dK and dV."""
    q, k, v, do = _bf16_inputs(B, S, KV, G, hd)
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     do.float(), causal=causal,
                                     window=window)
    got = _emulate_kernel(q, k, v, do, causal, window)
    ratios = [_bf16_limit_ratio(a, w) for a, w in zip(got, want)]
    assert max(ratios) <= 1.0, ratios


def test_one_bf16_rounding_of_p_and_ds_misses_the_limit():
    """Why the kernel splits P and dS in two bf16 terms: rounded once
    (FlashAttention-2's bf16 products), the gradient at a phase-3 shape
    of chip_smoke.py (S 130, G 5, hd 112) leaves the card's bf16 limit,
    while the split stays inside it."""
    q, k, v, do = _bf16_inputs(2, 130, 2, 5, 112)
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     do.float(), causal=True, window=0)
    once = _emulate_kernel(q, k, v, do, True, 0, split=False)
    split = _emulate_kernel(q, k, v, do, True, 0)
    assert max(_bf16_limit_ratio(a, w) for a, w in zip(once, want)) > 1.1
    assert max(_bf16_limit_ratio(a, w) for a, w in zip(split, want)) <= 1.0


@pytest.mark.parametrize("B,Sk,KV,G,sms,splits", [
    (2, 4096, 8, 4, 132, 1),      # danube's training shape: 1,024 blocks
    (1, 1000, 4, 12, 132, 5),     # 64 blocks: ceil(264 / 64)
    (1, 300, 1, 12, 132, 12),     # 5 blocks: every head its own block
    (2, 512, 32, 1, 132, 1),      # G 1 has nothing to split
    (1, 130, 1, 5, 1, 1),         # 3 blocks already fill 1 SM twice
    (1, 130, 1, 5, 2, 2),         # under 2 SMs twice: two blocks of heads
])
def test_kv_splits_fill_the_card(B, Sk, KV, G, sms, splits):
    """The dK / dV pass shares a KV head's query heads out over blocks only
    where its ceil(Sk / 64) KV B blocks are under two a streaming
    multiprocessor, and never over more blocks than heads."""
    assert ops.kv_splits(B, Sk, KV, G, sms) == splits
