"""The port's Mamba-2 SSD scan (`repro_torch.kernels.ssd_scan`) against the
JAX package on the CPU: the plain version of kernel 6 against
`ssd_intra_pallas` in interpret mode, the whole scan against the
reference's `ssd_scan` and `ssd_reference`, the decode step, and the
explicit backward formulas (the plain version of the gradient kernel)
against `torch.autograd` of the plain forward and `jax.grad` of the
reference.  Inputs are drawn with numpy.  Tolerances: 3e-4 for the scan,
as the reference's own kernel test (`test_kernels.py`: the cumsum and the
chunk matmuls sum in other orders); 1e-4 for gradients, whose sums are
over at most a few hundred f32 terms of magnitude ~1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan.kernel import ssd_intra_pallas  # noqa: E402
from repro.kernels.ssd_scan import ops as jax_ops  # noqa: E402
from repro.kernels.ssd_scan import ref as jax_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref  # noqa: E402

TOL = 3e-4
GTOL = 1e-4
# the four shapes of the reference's kernel test (tests/test_kernels.py)
SHAPES = [(2, 64, 4, 16, 1, 8, 16), (1, 128, 8, 32, 2, 16, 32),
          (2, 64, 4, 16, 1, 8, 16), (1, 256, 2, 64, 1, 128, 64)]


def _scan_inputs(B, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


def _chunked(x, dt, Bm, Cm, chunk):
    """The kernel's layout, as `ssd_scan` builds it (numpy)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    nc = S // chunk
    return (np.ascontiguousarray(
                x.reshape(B, nc, chunk, H, P).transpose(0, 3, 1, 2, 4)),
            np.ascontiguousarray(
                dt.reshape(B, nc, chunk, H).transpose(0, 3, 1, 2)[..., None]),
            np.ascontiguousarray(
                Bm.reshape(B, nc, chunk, G, N).transpose(0, 3, 1, 2, 4)),
            np.ascontiguousarray(
                Cm.reshape(B, nc, chunk, G, N).transpose(0, 3, 1, 2, 4)))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_intra_plain_matches_pallas_interpret(case):
    B, S, H, P, G, N, chunk = SHAPES[case]
    x, dt, A, Bm, Cm, _ = _scan_inputs(B, S, H, P, G, N, case)
    xr, dtr, Br, Cr = _chunked(x, dt, Bm, Cm, chunk)
    want = ssd_intra_pallas(jnp.asarray(xr), jnp.asarray(dtr),
                            jnp.asarray(A), jnp.asarray(Br), jnp.asarray(Cr),
                            interpret=True)
    got = ops.ssd_intra_fwd(*_t(xr, dtr, A, Br, Cr))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("case,use_init", [(0, False), (1, False), (2, True),
                                           (3, False), (1, True)])
def test_scan_matches_reference_scan_and_oracle(case, use_init):
    B, S, H, P, G, N, chunk = SHAPES[case]
    x, dt, A, Bm, Cm, h0 = _scan_inputs(B, S, H, P, G, N, 10 + case)
    init = h0 if use_init else None
    yk, hk = jax_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                              initial_state=init)
    yr, hr = jax_ref.ssd_reference(x, dt, A, Bm, Cm, chunk=chunk,
                                   initial_state=init)
    ti = None if init is None else torch.from_numpy(init)
    y, h = ops.ssd_scan(*_t(x, dt, A, Bm, Cm), chunk=chunk, initial_state=ti)
    y2, h2 = ref.ssd_reference(*_t(x, dt, A, Bm, Cm), chunk=chunk,
                               initial_state=ti)
    for got in ((y, h), (y2, h2)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(yk), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(hk), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(yr), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(hr), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_decode_step_matches_reference(G):
    rng = np.random.default_rng(G)
    B, H, P, N = 3, 4, 8, 16
    state = rng.normal(size=(B, H, P, N)).astype(np.float32)
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, H))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bt = rng.normal(size=(B, G, N)).astype(np.float32)
    Ct = rng.normal(size=(B, G, N)).astype(np.float32)
    yw, sw = jax_ref.ssd_decode_step(state, x, dt, A, Bt, Ct)
    y, s = ref.ssd_decode_step(*_t(state, x, dt, A, Bt, Ct))
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), rtol=TOL, atol=TOL)


def _intra_case(Bs, H, nc, Q, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bs, H, nc, Q, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bs, H, nc, Q, 1)))).astype(
        np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = (rng.normal(size=(Bs, G, nc, Q, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(Bs, G, nc, Q, N)) * 0.3).astype(np.float32)
    gy = rng.normal(size=(Bs, H, nc, Q, P)).astype(np.float32)
    gst = rng.normal(size=(Bs, H, nc, P, N)).astype(np.float32)
    gcs = rng.normal(size=(Bs, H, nc, Q, 1)).astype(np.float32)
    return (x, dt, A, Bm, Cm), (gy, gst, gcs)


INTRA_GRAD_CASES = [(2, 4, 2, 16, 8, 1, 8), (1, 4, 3, 12, 16, 2, 16),
                    (1, 2, 1, 64, 32, 1, 32)]


@pytest.mark.parametrize("case", INTRA_GRAD_CASES)
def test_intra_backward_formulas_match_autograd_and_jax_grad(case):
    inputs, grads = _intra_case(*case, seed=sum(case))
    ti = [t.requires_grad_() for t in _t(*inputs)]
    outs = ref.ssd_intra_plain(*ti)
    tg = _t(*grads)
    want = torch.autograd.grad(outs, ti, tg)
    with torch.no_grad():
        got = ref.ssd_intra_bwd_plain(*_t(*inputs), outs[2].detach(), *tg)

    def f(x, dt, A, Bm, Cm):
        # the reference's kernel function, through jnp (differentiable)
        y, st, cs = _jax_intra(x, dt, A, Bm, Cm)
        return (jnp.sum(y * grads[0]) + jnp.sum(st * grads[1])
                + jnp.sum(cs * grads[2]))
    jg = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, inputs))
    for g, a, j in zip(got, want, jg):
        assert g.shape == a.shape == j.shape
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=GTOL, atol=GTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=GTOL,
                                   atol=GTOL)


def _jax_intra(x, dt, A, Bm, Cm):
    """The intra-chunk part of `ssd_reference` on the kernel's layout:
    cumsum, segment-sum decay, scores, y and chunk states, in jnp."""
    H, G = x.shape[1], Bm.shape[1]
    Bh = jnp.repeat(Bm, H // G, axis=1)
    Ch = jnp.repeat(Cm, H // G, axis=1)
    dA = dt * A[None, :, None, None, None]
    cs = jnp.cumsum(dA, axis=3)
    L = jnp.exp(jax_ref._segsum(dA[..., 0]))
    u = x * dt
    y = jnp.einsum("bhcqk,bhckp->bhcqp",
                   jnp.einsum("bhcqn,bhckn->bhcqk", Ch, Bh) * L, u)
    w = jnp.exp(cs[..., -1:, :] - cs)
    st = jnp.einsum("bhcqp,bhcqn->bhcpn", u * w, Bh)
    return y, st, cs


def test_scan_gradient_through_kernel_function_matches_jax():
    """`ssd_scan` differentiated by autograd (inter-chunk ops) and the
    explicit backward (intra-chunk) against jax.grad of the reference."""
    B, S, H, P, G, N, chunk = 1, 48, 4, 8, 2, 8, 16
    x, dt, A, Bm, Cm, h0 = _scan_inputs(B, S, H, P, G, N, 7)
    rng = np.random.default_rng(8)
    gy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    gh = rng.normal(size=(B, H, P, N)).astype(np.float32)

    def f(x, dt, A, Bm, Cm, h0):
        y, h = jax_ref.ssd_reference(x, dt, A, Bm, Cm, chunk=chunk,
                                     initial_state=h0)
        return jnp.sum(y * gy) + jnp.sum(h * gh)
    want = jax.grad(f, argnums=tuple(range(6)))(x, dt, A, Bm, Cm, h0)
    ti = [t.requires_grad_() for t in _t(x, dt, A, Bm, Cm, h0)]
    y, h = ops.ssd_scan(*ti[:5], chunk=chunk, initial_state=ti[5])
    loss = (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum()
    loss.backward()
    for t, w in zip(ti, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=GTOL,
                                   atol=GTOL)


def test_intra_on_cpu_counts_no_launch_and_refuses_other_devices():
    inputs, grads = _intra_case(1, 2, 1, 8, 4, 1, 4, seed=0)
    n0 = (ops.ssd_intra.launches, ops.ssd_intra_bwd.launches)
    ti = [t.requires_grad_() for t in _t(*inputs)]
    y, st, cs = ops.ssd_intra(*ti)
    (y.sum() + st.sum() + cs.sum()).backward()
    assert (ops.ssd_intra.launches, ops.ssd_intra_bwd.launches) == n0
    meta = [torch.from_numpy(a).to("meta") for a in inputs]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd_intra_fwd(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd_intra_bwd(*meta, meta[1], *[torch.from_numpy(g).to("meta")
                                            for g in grads])
    with pytest.raises(ValueError, match="multiple of G"):
        ops.ssd_intra_fwd(*_t(inputs[0], inputs[1], inputs[2],
                              np.repeat(inputs[3], 3, 1),
                              np.repeat(inputs[4], 3, 1)))
