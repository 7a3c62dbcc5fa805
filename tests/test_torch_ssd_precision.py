"""The precision scheme of the SSD kernels (`ssd_scan/kernel.cu`,
`bwd_kernel.cu`), emulated on the CPU.

The kernels run their products on the tensor cores in three TF32 passes
(a = big + small with big = a cut to TF32, small = tf32(a - big); a b' is
big small' + small big' + big big' in a fresh sum per k-step of 8, added
to an f32 total with a rounded add), and the tensor cores cut the sums
they form (`mma_cut`: every addend cut to the largest one's 24 bits, the
sum cut to f32, toward zero); they compute C B^T
once per group on the FMA units in f32, sum a group's heads of gG in f32
in a fixed order, and keep gcs, gdA and gA in f64.  These tests put the
same roundings into a copy of the plain formulas (`ref.ssd_intra_plain`,
`ref.ssd_intra_bwd_plain`) and hold every output, gA included, within
rtol / atol 3e-4 of the float64 plain version, the check the kernels
meet on the card.  They also hold the ops wrappers' pure helpers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (_segsum_exp,  # noqa: E402
                                              ssd_intra_bwd_plain,
                                              ssd_intra_plain)

TOL = 3e-4


def tf32(a):
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as `cvt.rna.tf32.f32`: add half of the dropped 13 bits'
    range to the bit pattern and clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(a):
    """f32 with its 13 low mantissa bits cleared (a TF32 value)."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def cut_f32(x):
    """float64 -> float32 rounded toward zero."""
    x32 = x.float()
    over = x32.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def mma_cut(c, a, b):
    """One tensor-core step c + a @ b over a k-step of 8 TF32 values (c
    (..., M, N) f32, a (..., M, 8), b (..., 8, N)) as the tensor cores sum
    it: the products are exact, every addend (c and the 8 products) is cut
    to the 24-bit significand of the largest one, and the sum is cut to
    f32, both toward zero."""
    p = a.double()[..., :, :, None] * b.double()[..., None, :, :]
    terms = torch.cat([c.double()[..., :, None, :], p], -2)   # (..., M, 9, N)
    mx = terms.abs().amax(-2, keepdim=True)
    q = torch.exp2(torch.floor(torch.log2(torch.where(
        mx > 0, mx, torch.ones_like(mx)))) - 23)
    return cut_f32((torch.trunc(terms / q) * q).sum(-2))


def mm3(a, b, fresh=True):
    """a @ b in three TF32 passes, split as `split_tf32` does: big = a cut
    to TF32, small = the exact remainder rounded to TF32; every mma's sum
    cut as the tensor cores cut it (`mma_cut`).  ``fresh`` (the kernels'
    scheme, `warp_mma`): each k-step of 8 sums big small' + small big' +
    big big' in a fresh accumulator that is added to the f32 total with a
    rounded add.  ``fresh=False``: every mma runs into the one accumulator,
    the design whose gB missed the check on the card."""
    ab, bb = tf32_cut(a), tf32_cut(b)
    asm, bsm = tf32(a - ab), tf32(b - bb)
    K = a.shape[-1]
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, K, 8):
        s = slice(k0, k0 + 8)
        d = torch.zeros_like(acc) if fresh else acc
        d = mma_cut(d, ab[..., s], bsm[..., s, :])
        d = mma_cut(d, asm[..., s], bb[..., s, :])
        d = mma_cut(d, ab[..., s], bb[..., s, :])
        acc = acc + d if fresh else d
    return acc


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -1.0 - 2**-11,
                      1.0 + 2**-11 - 2**-20], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10, -1.0 - 2**-10, 1.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    one = (tf32(a) @ tf32(b)).double()
    three = mm3(a, b).double()
    # one pass keeps ~3 digits; three passes are as close as f32 products
    assert (one - exact).abs().max() > 1e-3
    assert (three - exact).abs().max() < 2e-5


def emulated_fwd(x, dt, A, Bm, Cm):
    """Kernel 6's arithmetic: CB per group in f32, S = CB o L o dt_j,
    y = S x and the state (x dt w)^T B in three TF32 passes."""
    H = x.shape[1]
    grp = torch.arange(H) * Bm.shape[1] // H
    CB = (Cm @ Bm.transpose(-1, -2)).index_select(1, grp)
    cs = torch.cumsum(dt * A[None, :, None, None, None], dim=3)
    L = _segsum_exp(cs[..., 0])
    y = mm3(CB * L * dt.transpose(-1, -2), x)
    w = torch.exp(cs[..., -1:, :] - cs)
    st = mm3((x * (dt * w)).transpose(-1, -2), Bm.index_select(1, grp))
    return y, st, cs


def emulated_bwd(x, dt, A, Bm, Cm, cs, gy, gst, gcs):
    """The gradient kernels' arithmetic: per head gS = gy x^T dt_j,
    gu = S^T gy + w (B gst^T) in three TF32 passes, gcs / gdA / gA in
    f64; per group the heads' gG summed in f32 in head order, then
    gC = (sum gG) B and gB = (sum gG)^T C + sum_h (x dt w)_h gst_h, the
    last one product over the group's heads and P."""
    Bs, H, nc, Q, P = x.shape
    G, N = Bm.shape[1], Bm.shape[4]
    grp = torch.arange(H) * G // H
    CB = (Cm @ Bm.transpose(-1, -2)).index_select(1, grp)
    Bh = Bm.index_select(1, grp)
    c = cs[..., 0]
    L = _segsum_exp(c)
    S = CB * L
    w = torch.exp(c[..., -1:] - c)[..., None]
    gS = (mm3(gy, x.transpose(-1, -2)) * dt.transpose(-1, -2)).tril()
    Bg = mm3(Bh, gst.transpose(-1, -2))
    gu = mm3(S.transpose(-1, -2), gy) + w * Bg
    gG = gS * L
    R = (gG * CB).double()
    g = gcs[..., 0].double() + R.sum(-1) - R.sum(-2)
    gww = ((x * dt) * Bg).sum(-1).double() * w[..., 0].double()
    g = g - gww
    g[..., -1] += gww.sum(-1)
    gdA = g.flip(-1).cumsum(-1).flip(-1)
    gdt = (gdA[..., None] * A[None, :, None, None, None].double()).float() \
        + (gu * x).sum(-1, keepdim=True)
    gA = (gdA[..., None] * dt.double()).sum((0, 2, 3, 4)).float()
    gGs = gG.view(Bs, G, H // G, nc, Q, Q)
    gsum = gGs[:, :, 0]
    for k in range(1, H // G):
        gsum = gsum + gGs[:, :, k]
    gC = mm3(gsum, Bm)
    xw = (x * (dt * w)).view(Bs, G, H // G, nc, Q, P).permute(
        0, 1, 3, 4, 2, 5).reshape(Bs, G, nc, Q, H // G * P)
    gsth = gst.view(Bs, G, H // G, nc, P, N).permute(0, 1, 3, 2, 4, 5) \
        .reshape(Bs, G, nc, H // G * P, N)
    gB = mm3(gsum.transpose(-1, -2), Cm) + mm3(xw, gsth)
    return gu * dt, gdt, gA, gB, gC


def _inputs(Bs, H, nc, Q, P, G, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.normal(size=sh).astype(np.float32))
    x, dt = f(Bs, H, nc, Q, P), torch.nn.functional.softplus(
        f(Bs, H, nc, Q, 1))
    A = -torch.exp(f(H) * 0.3)
    Bm, Cm = f(Bs, G, nc, Q, N) * 0.3, f(Bs, G, nc, Q, N) * 0.3
    return (x, dt, A, Bm, Cm), (f(Bs, H, nc, Q, P), f(Bs, H, nc, P, N),
                                f(Bs, H, nc, Q, 1))


def _err_over_tol(got, want):
    return max(float(((a.double() - b).abs()
                      / (TOL + TOL * b.abs())).max())
               for a, b in zip(got, want))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_three_pass_tf32_meets_the_kernels_tolerance(seed):
    """A training-like block (Q 256, P 64, N 128, 4 heads of one group)."""
    ins, grads = _inputs(1, 4, 1, 256, 64, 1, 128, seed)
    d = [t.double() for t in ins]
    fwd = emulated_fwd(*ins)
    exact_fwd = ssd_intra_plain(*d)
    r_fwd = _err_over_tol(fwd, exact_fwd)
    bwd = emulated_bwd(*ins, fwd[2], *grads)
    exact_bwd = ssd_intra_bwd_plain(*d, fwd[2].double(),
                                    *[g.double() for g in grads])
    r_bwd = [_err_over_tol([a], [b]) for a, b in zip(bwd, exact_bwd)]
    print(f"seed {seed}: forward {r_fwd:.3f}, gradient (gx, gdt, gA, gB, "
          f"gC) {', '.join(f'{r:.3f}' for r in r_bwd)}")
    assert r_fwd <= 1.0 and max(r_bwd) <= 1.0, (r_fwd, r_bwd)


@pytest.mark.parametrize("H,G,Q", [(12, 3, 64), (6, 1, 40)])
def test_emulation_matches_plain_on_group_and_ragged_shapes(H, G, Q):
    """The emulated group sums and the head-concatenated product keep the
    plain formulas' layout for several heads a group and a ragged Q."""
    ins, grads = _inputs(1, H, 2, Q, 24, G, 20, 7)
    d = [t.double() for t in ins]
    fwd = emulated_fwd(*ins)
    assert _err_over_tol(fwd, ssd_intra_plain(*d)) <= 1.0
    bwd = emulated_bwd(*ins, fwd[2], *grads)
    want = ssd_intra_bwd_plain(*d, fwd[2].double(),
                               *[g.double() for g in grads])
    assert all(a.shape == b.shape for a, b in zip(bwd, want))
    assert _err_over_tol(bwd, want) <= 1.0


@pytest.mark.parametrize("Q,pairs", [(12, 1), (64, 1), (65, 3), (200, 10),
                                     (256, 10)])
def test_pair_scratch_holds_one_tile_per_causal_tile_pair(Q, pairs):
    assert ops.pair_scratch_shape(4, 3, 8, Q) == (4, 3, 8, pairs, 64, 64)


def test_pair_scratch_at_the_training_shape_stays_small():
    """Two buffers of the gradient at B 4, G 1, nc 8, Q 256: 10.5 MB, far
    under the 268 MB of per-head (B, H, nc, Q, N) partials they replace."""
    shape = ops.pair_scratch_shape(4, 1, 8, 256)
    assert 2 * 4 * int(np.prod(shape)) == 10_485_760


def test_grid_limits_are_checked_before_a_launch():
    x = torch.zeros(1, 1, 20_000, 256, 1).to("meta")
    Bm = torch.zeros(1, 1, 20_000, 256, 1).to("meta")
    with pytest.raises(ValueError, match="row tiles"):
        ops._dims(x, Bm)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cut_sums_single_accumulator_gb_against_fresh_sum_per_k_step(seed):
    """gB's sum over a group's 32 heads, sum_h (x dt w)_h gst_h: 2,048
    terms, 24 mma a k-tile of 64 (8 k-steps x 3 passes).  With every mma's
    sum cut (`mma_cut`), the kernels' fresh sum per k-step stays within a
    tenth of the 3e-4 check, and running all 768 mma into one accumulator
    leaves at least three times its error (0.19-0.46 of the check against
    0.02-0.06 over these seeds).  On the card the one-accumulator design
    missed the check (2.44x over the whole gradient); this model of the
    cut, every addend cut at the largest one's 24th bit, does not reach
    that far."""
    ins, grads = _inputs(1, 32, 1, 256, 64, 1, 128, seed)
    x, dt = ins[0], ins[1]
    cs = emulated_fwd(*ins)[2][..., 0]
    w = torch.exp(cs[..., -1:] - cs)[..., None]
    # the chunk's last 128 rows, where the decay w leaves the terms large
    a = (x * (dt * w))[0, :, 0].permute(1, 0, 2).reshape(256, 32 * 64)[128:]
    b = grads[1][0, :, 0].reshape(32 * 64, 128)
    exact = a.double() @ b.double()
    fresh = _err_over_tol([mm3(a, b)], [exact])
    single = _err_over_tol([mm3(a, b, fresh=False)], [exact])
    print(f"seed {seed}: fresh {fresh:.3f}, one accumulator {single:.3f}")
    assert fresh <= 0.1 and single >= 3 * fresh, (fresh, single)
