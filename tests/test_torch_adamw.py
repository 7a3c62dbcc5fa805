"""AdamW's two hand-written passes (`repro_torch.kernels.adamw`) on the CPU:
`plan` cuts any set of leaves into launches whose blocks cover every
element once (leaves larger than a block, empty leaves, offsets past
2^31, more leaves than a launch holds); the update pass's per-element
arithmetic, emulated in numpy f32, gives the `_foreach` chain's bits; the
passes' plain versions give the `_foreach` chain's bits and
`global_norm`'s norm; and `training.optimizer.update` chooses its path by
the device alone, counting the leaves the passes take.  The kernels
themselves run in the `gpu` tests (`test_torch_gpu.py`)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.kernels.adamw import ops, ref  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402

CHUNK = ops.CHUNK


def _covers(numels, launches):
    """Every non-empty leaf's elements are covered once, in order, by the
    blocks of one launch; each launch holds at most `MAX_LEAVES` leaves,
    in the leaves' order; block ids fit the kernel's 32-bit int."""
    seen = {}
    order = []
    for ln in launches:
        assert 0 < len(ln.leaves) <= ops.MAX_LEAVES
        assert len(ln.start) == len(ln.leaves) + 1 and ln.start[0] == 0
        assert ln.start[-1] < 2**31
        order += ln.leaves
        for i, off, n in ref.block_slices(ln, numels, CHUNK):
            assert 0 < n <= CHUNK and off % CHUNK == 0
            assert seen.get(i, 0) == off, (i, off)
            seen[i] = off + n
    assert order == sorted(order)
    assert seen == {i: n for i, n in enumerate(numels) if n}


@pytest.mark.parametrize("numels", [
    [3 * CHUNK + 5],                                   # a leaf of 4 blocks
    [0, 10, 0, 0, CHUNK, 0, CHUNK + 1, 0],             # empty leaves
    [2**31 + 7, 5, 3 * 2**30 + 3],                     # offsets past 2^31
    [1, 2, 3, 4, 5] * 40,                              # 200 leaves
    [CHUNK - 1, CHUNK, CHUNK + 1, 4 * CHUNK] * 20,     # 80 leaves, many blocks
    [0, 0, 0],                                         # nothing to do
])
def test_plan_covers_every_element_once(numels):
    launches = ops.plan(numels)
    _covers(numels, launches)
    nonempty = sum(1 for n in numels if n)
    assert len(launches) == -(-nonempty // ops.MAX_LEAVES)
    if max(numels) > 2**31:
        offs = [off for ln in launches
                for _, off, _ in ref.block_slices(ln, numels, CHUNK)]
        assert max(offs) > 2**31


def test_plan_of_a_model_sized_leaf_set():
    """h2o-danube-1.8b's 219 leaves (24 layers of 9, the embedding, the
    head, the final norm) take 4 launches of at most 64 leaves."""
    d, kv, f, V = 2560, 640, 6912, 32000
    layer = [d, d * d, d * kv, d * kv, d * d, d, d * f, d * f, f * d]
    numels = [V * d, d * V, d] + layer * 24
    launches = ops.plan(numels)
    assert len(numels) == 219 and [len(ln.leaves) for ln in launches] == \
        [64, 64, 64, 27]
    assert sum(ln.start[-1] for ln in launches) == sum(
        -(-n // CHUNK) for n in numels)


def test_leaf_flags_of_mixed_and_misaligned_leaves():
    """bf16 and f32 gradients and parameters in any mix set their own
    flags; a tensor that starts off a 4-element boundary (a view one
    element into its buffer) takes the leaf off the vector loads."""
    bf16, f32 = torch.bfloat16, torch.float32
    g16, g32 = torch.zeros(64, dtype=bf16), torch.zeros(64, dtype=f32)
    st = [torch.zeros(64) for _ in range(3)]
    V = ops.VECTOR
    assert ops.leaf_flags(g16) == ops.G_BF16 | V
    assert ops.leaf_flags(g32) == V
    assert ops.leaf_flags(g16, g16, *st) == ops.G_BF16 | ops.P_BF16 | V
    assert ops.leaf_flags(g32, g16, *st) == ops.P_BF16 | V
    assert ops.leaf_flags(g16, g32, *st) == ops.G_BF16 | V
    off16, off32 = torch.zeros(65, dtype=bf16)[1:], torch.zeros(65)[1:]
    assert ops.leaf_flags(off16) == ops.G_BF16
    assert ops.leaf_flags(g32, off16, *st) == ops.P_BF16
    assert ops.leaf_flags(g16, g16, st[0], off32, st[2]) == \
        ops.G_BF16 | ops.P_BF16
    # 4 bf16 elements are 8 bytes: an offset of 4 keeps the vector loads
    assert ops.leaf_flags(torch.zeros(68, dtype=bf16)[4:]) == ops.G_BF16 | V


def _torch_root(x):
    return torch.sqrt(torch.from_numpy(x)).numpy()


def _emulated_step(g, m, v, w, scale, lr, bc1, bc2, opt):
    f32 = np.float32
    consts = tuple(f32(c) for c in (opt.b1, 1 - opt.b1, opt.b2, 1 - opt.b2,
                                    opt.eps, opt.weight_decay))
    return ref.adamw_elementwise(g, m, v, w, f32(scale), f32(lr), f32(bc1),
                                 f32(bc2), consts, _torch_root)


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_update_arithmetic_emulated_in_numpy_is_the_foreach_path(dtype):
    """Three steps with the clip active, gradients and weights over many
    magnitudes (down to 1e-30, and zeros): numpy's f32 operations in
    `ref.adamw_elementwise`'s order give the `_foreach` chain's m, v,
    master and parameter bits.  The square root is torch's: on the CPU it
    is not always the correctly rounded one (numpy's, and the card's
    ``sqrtf`` that `kernel.cu`'s ``__fsqrt_rn`` matches), and differs
    from it by at most 1 ulp."""
    rng = np.random.default_rng(3)
    n = 4099
    mag = 10.0 ** rng.uniform(-30, 3, n)
    w0 = (rng.normal(size=n) * mag).astype(np.float32)
    w0[:5] = 0
    params = {"a": torch.from_numpy(w0).to(dtype)}
    opt = O.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    st = O.init(params)
    m = np.zeros(n, np.float32)
    v = np.zeros(n, np.float32)
    w = st["master"]["a"].numpy().copy()
    for step in range(1, 4):
        gmag = 10.0 ** rng.uniform(-20, 2, n)
        g = torch.from_numpy((rng.normal(size=n) * gmag).astype(
            np.float32)).to(dtype)
        g[7] = 0
        gnorm = O.global_norm({"a": g})
        scale = torch.clamp(opt.clip_norm / (gnorm + 1e-9), max=1.0)
        stepf = torch.tensor(float(step))
        lr = O.schedule(opt, step)
        bc1, bc2 = 1 - opt.b1 ** stepf, 1 - opt.b2 ** stepf
        assert float(scale) < 1
        O.update(opt, {"a": g}, st, params)
        m, v, w = _emulated_step(g.float().numpy(), m, v, w, scale, lr, bc1,
                                 bc2, opt)
        for got, want in ((st["m"]["a"], m), (st["v"]["a"], v),
                          (st["master"]["a"], w)):
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        np.testing.assert_array_equal(
            _bits(params["a"].float().numpy()),
            _bits(torch.from_numpy(w).to(dtype).float().numpy()))
        q = v / np.float32(bc2)
        ulps = np.abs(_bits(np.sqrt(q)).astype(np.int64)
                      - _bits(_torch_root(q)).astype(np.int64))
        assert ulps.max() <= 1


def _mixed_leaves(seed):
    """Leaves the passes take (bf16, f32, an odd size, an empty one) and
    ones they refuse (a transposed, non-contiguous parameter, an f16
    one)."""
    g = torch.Generator().manual_seed(seed)
    params = {"bf16": torch.randn(33, 17, generator=g).bfloat16(),
              "f32": torch.randn(CHUNK + 3, generator=g),
              "odd": torch.randn(5, generator=g).bfloat16(),
              "empty": torch.zeros(0, 4).bfloat16(),
              "transposed": torch.randn(6, 9, generator=g).t(),
              "f16": torch.randn(40, generator=g).half()}
    grads = [{k: torch.randn(p.shape, generator=g).to(p.dtype) * 1e-3
              for k, p in params.items()} for _ in range(2)]
    grads[0]["transposed"] = grads[0]["transposed"].t().contiguous().t()
    return params, grads


TAKEN = ("bf16", "f32", "odd", "empty")


def test_update_takes_each_leaf_down_its_path():
    """On the CPU every leaf, the ones the passes refuse too, takes the
    `_foreach` chain (no leaf counted as fused); the passes' plain
    versions (`ops.clip_scale`, `ops.adamw_update` on CPU tensors) over
    the leaves they take give the same bits, the norm within 1e-6 of
    `global_norm`'s.  On the card the transposed and the f16 leaves would
    be refused (`ops.leaf_ok`, `ops.grad_ok`)."""
    params, grads = _mixed_leaves(5)
    st = O.init(params)
    opt = O.OptConfig(warmup_steps=1, clip_norm=0.05)
    taken = {k: params[k].clone() for k in TAKEN}
    tst = O.init(taken)
    consts = (opt.b1, 1 - opt.b1, opt.b2, 1 - opt.b2, opt.eps,
              opt.weight_decay)
    tracing.reset()
    tracing.enable()
    try:
        for step, gr in enumerate(grads, 1):
            met = O.update(opt, gr, st, params)
            gl = [gr[k] for k in TAKEN]
            gnorm, scale = ops.clip_scale(gl, opt.clip_norm)
            want = O.global_norm({k: gr[k] for k in TAKEN})
            torch.testing.assert_close(gnorm, want, rtol=1e-6, atol=0)
            assert float(scale) < 1
            # the same scale for both paths: the update's bits alone
            scale = O.clip_factor(opt.clip_norm, met["grad_norm"])
            stepf = torch.tensor(float(step))
            ops.adamw_update(gl, *([tst[s][k] for k in TAKEN]
                                   for s in ("m", "v", "master")),
                             [taken[k] for k in TAKEN], scale, met["lr"],
                             1 - opt.b1 ** stepf, 1 - opt.b2 ** stepf,
                             consts)
            for k in TAKEN:
                assert torch.equal(params[k], taken[k]), k
                for s in ("m", "v", "master"):
                    assert torch.equal(st[s][k], tst[s][k]), (s, k)
        counters = tracing.summary()["counters"]
    finally:
        tracing.disable()
        tracing.reset()
    assert {k: counters[k]["total"] for k in ("optimizer.leaves",
                                              "optimizer.fused_leaves")} \
        == {"optimizer.leaves": 12, "optimizer.fused_leaves": 0}
    dev = torch.device("cpu")
    st0 = O.init(params)
    lf = {k: (grads[0][k], st0["m"][k], st0["v"][k], st0["master"][k],
              params[k]) for k in params}
    assert [k for k in params if ops.leaf_ok(dev, *lf[k])] == list(TAKEN)
    assert not ops.grad_ok(grads[0]["transposed"], dev)
    assert not ops.grad_ok(grads[0]["f16"], dev)


def test_norm_pass_takes_plain_gradients():
    """The norm pass's plain version (`ops.clip_scale`, `ops.sumsq` on
    CPU tensors): the norm within 1e-6 of `global_norm`'s, the clip's
    scale its formula on that norm bit for bit, the sum of squares the
    norm's square; no gradients at all is refused."""
    _, grads = _mixed_leaves(7)
    ok = {k: grads[1][k] for k in TAKEN}
    gnorm, scale = ops.clip_scale(list(ok.values()), 0.05)
    want = O.global_norm(ok)
    torch.testing.assert_close(gnorm, want, rtol=1e-6, atol=0)
    assert float(scale) < 1
    assert torch.equal(scale, O.clip_factor(0.05, gnorm))
    total = ops.sumsq(list(ok.values()))
    assert total.dtype == torch.float64 and total.dim() == 0
    torch.testing.assert_close(torch.sqrt(total).float(), gnorm, rtol=0,
                               atol=0)
    with pytest.raises(ValueError):
        ops.clip_scale([], 1.0)
    with pytest.raises(ValueError):
        ops.sumsq([])
