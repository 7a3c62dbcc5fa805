"""The plain version of the flash attention backward (kernel 2b,
`flash_attention_bwd_plain`, the yardstick of `bwd_kernel.cu` on the card)
against `jax.grad` of the reference's `attend_ref`, which is what the JAX
trainer differentiates: dQ, dK and dV for causal, windowed (window < S) and
non-causal attention, GQA with G = 1, 5 and 12, head dims 64, 80, 112 and
128, S not a multiple of the kernels' 64-row tiles, f32 and bf16.

Tolerances: f32 1e-4 (abs and rel): the two frameworks sum the products
in other orders (~1e-6).  bf16: both compute in f32 and round to bf16
last, so two results may sit a bf16 step apart: 1e-2 abs plus 2^-7 rel."""
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
