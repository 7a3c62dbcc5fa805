"""The port's CUDA kernels against their plain-torch versions on a GPU.

Marked `gpu`; each test skips (deciding inside the test) where there is
no CUDA device.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports torch and numpy only, so it runs where JAX is not
installed; the JAX parity of the plain versions is held in
`test_torch_kernels.py` and `test_torch_ivf.py` on the CPU.  Tolerances:
1e-5 for kNN and IVF scores, rtol 1e-4 / atol 1e-5 for ADC scores, 2e-5
for f32 attention, 5e-2 for bf16 (the reference tests'), rtol / atol 3e-4
for the SSD pass and its gradient (the reference's SSD kernel test)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_reference  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_reference  # noqa: E402
from repro_torch.kernels.knn_ivf import ops as ivf_ops  # noqa: E402
from repro_torch.kernels.knn_ivf.ref import (ivf_probe, ivf_scan_plain,  # noqa: E402
                                             ivfpq_adc_plain)
from repro_torch.kernels.knn_topk import ops as knn_ops  # noqa: E402
from repro_torch.kernels.knn_topk.ops import knn_topk  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_reference  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (ssd_intra_bwd_plain,  # noqa: E402
                                              ssd_intra_plain)


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _knn_data(Q, N, D, seed):
    rng = np.random.default_rng(seed)
    return (_unit(rng.normal(size=(Q, D))),
            rng.normal(size=(N, D)).astype(np.float32))


def _attn_data(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


def _decode_data(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")


def _device_kernels(fn, windows=3):
    """(fn's result, the names of the CUDA kernels one call of fn launches,
    each as often as it ran), read as chip_smoke.py's `device_profile` reads
    them: a warm call, then torch.profiler over CPU and CUDA activity with a
    traced and discarded warm-up call first (on an H100 a window opened on
    the call itself can miss its first kernels, more often later in a run),
    the window's `key_averages`, and a window that records no kernel taken
    again, up to ``windows`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(windows):
        fn()
        torch.cuda.synchronize()
        traced = []
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1),
                       on_trace_ready=lambda p: traced.append(
                           p.key_averages()))
        prof.start()
        try:
            fn()
            torch.cuda.synchronize()
            prof.step()
            out = fn()
            torch.cuda.synchronize()
            prof.step()
        finally:
            prof.stop()
        names = [e.key for e in (traced[0] if traced else [])
                 if str(e.device_type).endswith("CUDA")
                 and not e.key.startswith("ProfilerStep")
                 for _ in range(e.count)]
        if names:
            break
    return out, names


def _device_kernels_fresh(setup):
    """For each call in ``fns``, a list that the code ``setup`` defines
    (run with this module as ``t``), the names of the CUDA kernels it
    launches, read by `_device_kernels` in a fresh process: in a test
    process that had profiled other calls before, the profiler's windows
    on an H100 came back empty (the fused IVF-PQ kernel's in every run),
    where a fresh process records the same call."""
    import json
    import os
    import subprocess
    import sys
    import textwrap
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import json, sys\nsys.path.insert(0, {here!r})\n"
            "import test_torch_gpu as t\n" + textwrap.dedent(setup)
            + "\nprint('KERNELS ' + json.dumps("
            "[t._device_kernels(f)[1] for f in fns]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"),
         os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("KERNELS ")][-1]
    return json.loads(line[len("KERNELS "):])


@pytest.mark.gpu
@pytest.mark.parametrize("Q,N,k", [(16, 70_000, 10), (33, 5_003, 100),
                                   (7, 50, 64)])
def test_gpu_knn_kernel_matches_plain(Q, N, k):
    _need_cuda()
    q, s = _knn_data(Q, N, 768, N)
    qd, sd = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
    n0 = knn_topk.launches
    ks, ki = knn_topk(qd, sd, k)
    rs, ri = knn_topk_reference(qd, sd, k)
    assert knn_topk.launches == n0 + 1
    torch.testing.assert_close(ks, rs, rtol=1e-5, atol=1e-5)
    assert torch.equal(ki < 0, ri < 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,S,H,KV,hd,causal,window,tol,seed", [
    (torch.float32, 2, 100, 8, 2, 64, True, 0, 2e-5, 64),
    (torch.bfloat16, 2, 100, 8, 2, 128, True, 32, 5e-2, 128),
    (torch.float32, 2, 100, 8, 2, 80, True, 16, 2e-5, 80),
    (torch.float32, 32, 64, 12, 12, 64, True, 0, 2e-5, 128),   # the encoder's
    (torch.float32, 2, 130, 8, 2, 64, True, 0, 2e-5, 194),     # S % 64 != 0
    (torch.float32, 2, 200, 8, 8, 80, False, 0, 2e-5, 280),
    (torch.bfloat16, 1, 320, 8, 2, 64, True, 128, 5e-2, 384),  # window % 64 == 0
    # one key tile holding fewer than 64 keys, GQA, a window, no mask
    (torch.float32, 64, 37, 12, 4, 64, True, 0, 2e-5, 101),
    (torch.float32, 4, 50, 8, 8, 80, False, 16, 2e-5, 130),
    (torch.bfloat16, 96, 64, 16, 4, 128, True, 0, 5e-2, 192),
    (torch.bfloat16, 8, 48, 8, 2, 64, True, 0, 5e-2, 112),
])
def test_gpu_flash_kernel_matches_plain(dtype, B, S, H, KV, hd, causal,
                                        window, tol, seed):
    _need_cuda()
    q, k, v = (torch.from_numpy(x).cuda().to(dtype)
               for x in _attn_data(B, S, H, KV, hd, seed))
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention_reference(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd,ring,tol,S,pos,seed", [
    (torch.bfloat16, 128, False, 5e-2, 100, [0, 99, 99, 37], 128),
    (torch.bfloat16, 80, True, 5e-2, 100, [0, 99, 150, 37], 80),
    (torch.float32, 64, True, 2e-5, 100, [0, 99, 150, 37], 64),
    # edges of the 64-row spans: 0, one span - 1, one span, S - 1, two
    # spans - 1, two spans; and slots with no valid key
    (torch.bfloat16, 128, False, 5e-2, 300, [0, 63, 64, 299], 428),
    (torch.float32, 64, False, 2e-5, 300, [-1, 127, 128, 299], 364),
    (torch.float32, 80, True, 2e-5, 300, [-1, 64, 300, 1000], 380),
    (torch.float32, 128, True, 2e-5, 256, [127, 128, 255, 700], 384),
])
def test_gpu_decode_kernel_matches_plain(dtype, hd, ring, tol, S, pos, seed):
    _need_cuda()
    q, ck, cv = (torch.from_numpy(x).cuda().to(dtype)
                 for x in _decode_data(4, S, 32, 8, hd, seed))
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    n0 = decode_attention.launches
    out = decode_attention(q, ck, cv, pos, ring=ring)
    assert decode_attention.launches == n0 + 1
    ref = decode_attention_reference(q, ck, cv, pos, ring=ring)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert (out[pos < 0] == 0).all()


def _ivf_index(pq, nbits=8, N=6000, D=128, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, D)) * 3
    s = _unit(centers[rng.integers(0, 16, N)] + rng.normal(size=(N, D)))
    q = _unit(centers[rng.integers(0, 16, 33)] + rng.normal(size=(33, D)))
    build = ivf_ops.build_ivfpq_index if pq else ivf_ops.build_ivf_index
    kw = {"m": 16, "nbits": nbits} if pq else {}
    return torch.from_numpy(q).cuda(), build(s, 32, seed=seed,
                                             device="cuda", **kw)


def _check_tied(ks, ki, rs, ri, rtol, atol):
    torch.testing.assert_close(ks, rs, rtol=rtol, atol=atol)
    assert torch.equal(ki < 0, ri < 0)
    ks, ki, rs, ri = (t.cpu().numpy() for t in (ks, ki, rs, ri))
    for r, c in zip(*np.nonzero(ki != ri)):
        near = np.abs(rs[r] - ks[r, c]) <= atol + rtol * abs(ks[r, c])
        assert ki[r, c] in ri[r][near]


@pytest.mark.gpu
@pytest.mark.parametrize("nprobe,k", [(4, 10), (8, 100), (32, 1024)])
def test_gpu_ivf_scan_kernel_matches_plain(nprobe, k):
    _need_cuda()
    q, index = _ivf_index(pq=False)
    probe = ivf_probe(q, index.centroids, nprobe)
    args = (q, probe, index.sup_cm, index.ids_cm, index.inv_cm, k)
    n0 = ivf_ops.ivf_scan.launches
    ks, ki = ivf_ops.ivf_scan(*args)
    assert ivf_ops.ivf_scan.launches == n0 + 1
    _check_tied(ks, ki, *ivf_scan_plain(*args), 1e-5, 1e-5)


def _ivf_synthetic(C, L, D, counts, seed=0):
    """An IVF index of unit rows, counts[c] valid in list c (ids -1, inv 0
    past them), centroids the lists' normalised means, on the card."""
    rng = np.random.default_rng(seed)
    sup = np.zeros((C, L, D), np.float32)
    ids = np.full((C, L), -1, np.int32)
    at = 0
    for c, n in enumerate(counts):
        sup[c, :n] = _unit(rng.normal(size=(n, D)))
        ids[c, :n] = np.arange(at, at + n)
        at += n
    inv = (ids >= 0).astype(np.float32)
    cent = sup.sum(1)
    cent /= np.maximum(np.linalg.norm(cent, axis=1, keepdims=True), 1e-12)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    return t(cent.astype(np.float32)), t(sup), t(ids), t(inv)


def _ivf_tile_case(kind):
    """(index, queries, probe, k) of one kernel-4 case."""
    main = (265, 400, 768, [70_000 // 265 + (c < 70_000 % 265)
                            for c in range(265)])
    if kind == "nprobe=C":
        idx = _ivf_synthetic(24, 48, 128, [40] * 24, seed=1)
        Q, P, k = 16, 24, 100
    elif kind == "short lists":
        idx = _ivf_synthetic(32, 64, 128, [3 + c % 4 for c in range(32)],
                             seed=2)
        Q, P, k = 16, 2, 100
    else:
        idx = _ivf_synthetic(*main)
        Q, P, k = 16, 8, 100
        if kind.startswith("Q="):
            Q = int(kind[2:])
        elif kind.startswith("k="):
            k = int(kind[2:])
    rng = np.random.default_rng(len(kind) + Q + k)
    q = torch.from_numpy(_unit(rng.normal(size=(Q, idx[1].shape[2])))).cuda()
    probe = ivf_probe(q[:1] if kind == "shared probes" else q, idx[0], P)
    return idx, q, probe.expand(Q, P).contiguous(), k


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["Q=1", "Q=16", "Q=17", "Q=64",
                                  "shared probes", "nprobe=C", "short lists",
                                  "k=1", "k=2048", "k=2049"])
def test_gpu_ivf_tile_kernel_matches_plain(kind):
    """Kernel 4 against its plain version at the main shape (265 lists of
    400 x 768, nprobe 8) and its edge cases: one query, a partial query
    tile (17), four tiles (64), 16 queries on one probe set, nprobe = C,
    lists holding fewer valid rows than k, k 1 and 2,048 (one CUDA launch)
    and 2,049 (the scan and three selection rounds).  Two calls in a row
    return the same bits and leave the tickets at zero."""
    _need_cuda()
    (_, sup, ids, inv), q, probe, k = _ivf_tile_case(kind)
    args = (q, probe, sup, ids, inv, k)
    n0 = ivf_ops.ivf_scan.launches
    a = ivf_ops.ivf_scan(*args)
    assert ivf_ops.ivf_scan.launches == n0 + 1
    assert ivf_ops.ivf_scan.last_cuda_launches == (
        1 if k <= 2048 else 1 + -(-k // 1024))
    b = ivf_ops.ivf_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(int(t.abs().sum()) == 0 for t in ivf_ops._tickets.values())
    _check_tied(*a, *ivf_scan_plain(*args), 1e-5, 1e-5)
    if kind == "short lists":
        assert (a[1] == -1).any() and torch.isinf(a[0][a[1] < 0]).all()


@pytest.mark.gpu
def test_gpu_ivf_tile_kernel_takes_duplicate_and_padded_probes():
    """D = 30 (4-byte copies), a list probed twice by one query (its rows
    come twice, as in the plain version) and a padded query (a probe row of
    -1: empty result)."""
    _need_cuda()
    cent, sup, ids, inv = _ivf_synthetic(20, 72, 30, [60] * 20, seed=4)
    q = torch.from_numpy(_unit(np.random.default_rng(4).normal(
        size=(20, 30)))).cuda()
    probe = ivf_probe(q, cent, 5)
    probe[5, 2] = probe[5, 0]
    probe[3] = -1
    out = ivf_ops.ivf_scan(q, probe, sup, ids, inv, 50)
    assert (out[1][3] == -1).all() and torch.isneginf(out[0][3]).all()
    live = torch.arange(20, device="cuda") != 3
    ref = ivf_scan_plain(q[live], probe[live], sup, ids, inv, 50)
    _check_tied(out[0][live], out[1][live], *ref, 1e-5, 1e-5)
    row = out[1][5][out[1][5] >= 0].tolist()
    assert len(row) > len(set(row))


@pytest.mark.gpu
def test_gpu_ivf_one_launch_at_the_main_shape():
    """k <= 2,048 is a single CUDA kernel a call (read with torch.profiler
    and the kernel library's own count)."""
    _need_cuda()
    [kernels] = _device_kernels_fresh("""
        (_, sup, ids, inv), q, probe, k = t._ivf_tile_case("Q=16")
        fns = [lambda: t.ivf_ops.ivf_scan(q, probe, sup, ids, inv, k)]""")
    assert len(kernels) == 1 and "ivf_tile_kernel" in kernels[0], kernels
    (_, sup, ids, inv), q, probe, k = _ivf_tile_case("Q=16")
    ivf_ops.ivf_scan(q, probe, sup, ids, inv, k)
    assert ivf_ops.ivf_scan.last_cuda_launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("nbits,nprobe,k", [(8, 8, 800), (4, 8, 100),
                                            (8, 32, 1024)])
def test_gpu_ivfpq_adc_kernel_matches_plain(nbits, nprobe, k):
    _need_cuda()
    q, index = _ivf_index(pq=True, nbits=nbits)
    probe = ivf_probe(q, index.centroids, nprobe)
    args = (q, probe, index.codes_cm, index.ids_cm, index.inv_cm,
            index.anchors, index.codebooks, k)
    n0 = ivf_ops.ivfpq_adc.launches
    ks, ki = ivf_ops.ivfpq_adc(*args, m=index.m, nbits=nbits)
    assert ivf_ops.ivfpq_adc.launches == n0 + 1
    _check_tied(ks, ki, *ivfpq_adc_plain(*args, index.m, nbits), 1e-4, 1e-5)


@pytest.mark.gpu
def test_gpu_cuda_tensors_never_take_the_plain_version(monkeypatch):
    _need_cuda()

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ivf_ops, "ivf_scan_plain", refuse)
    monkeypatch.setattr(ivf_ops, "ivfpq_adc_plain", refuse)
    # attention: both decode kernels (split and combine) and the flash
    # kernel run on a CUDA tensor; the plain versions are never reached
    import repro_torch.kernels.decode_attention.ops as dops
    import repro_torch.kernels.flash_attention.ops as fops
    monkeypatch.setattr(dops, "decode_attention_reference", refuse)
    monkeypatch.setattr(fops, "flash_attention_reference", refuse)
    q, ck, cv = (torch.from_numpy(x).cuda()
                 for x in _decode_data(2, 200, 8, 2, 64, 0))
    pos = torch.tensor([150, -1], dtype=torch.int32, device="cuda")
    out = dops.decode_attention(q, ck, cv, pos)
    assert out.is_cuda and torch.isfinite(out).all() and (out[1] == 0).all()
    a = torch.zeros((1, 64, 2, 64), device="cuda")
    assert fops.flash_attention(a, a, a).is_cuda
    for pq in (False, True):
        q, index = _ivf_index(pq=pq, N=2000)
        search = ivf_ops.ivfpq_topk if pq else ivf_ops.ivf_topk
        sc, ix = search(q, index, 10)
        assert sc.is_cuda and ix.is_cuda and (ix >= 0).all()
    # m=256 subspaces at nbits 8: a 256 KB table does not fit; refused
    z = dict(device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        ivf_ops.ivfpq_adc(torch.zeros((1, 256), **z),
                          torch.zeros((1, 1), dtype=torch.int32, **z),
                          torch.zeros((1, 256, 8), dtype=torch.uint8, **z),
                          torch.zeros((1, 8), dtype=torch.int32, **z),
                          torch.zeros((1, 8), **z), torch.zeros((1, 256), **z),
                          torch.zeros((256, 256, 1), **z), 5, m=256, nbits=8)


@pytest.mark.gpu
@pytest.mark.parametrize("pq", [False, True])
def test_gpu_short_lists_fill_empty_slots(pq):
    """40 rows in lists padded to 128: more candidates than k, fewer valid
    ones, so the tail is -inf / -1 and the kernel still equals its plain
    version."""
    _need_cuda()
    rng = np.random.default_rng(5)
    s = _unit(rng.normal(size=(40, 64)))
    q = torch.from_numpy(_unit(rng.normal(size=(6, 64)))).cuda()
    if pq:
        index = ivf_ops.build_ivfpq_index(s, 8, m=8, lane_pad=128,
                                          device="cuda")
        probe = ivf_probe(q, index.centroids, 8)
        args = (q, probe, index.codes_cm, index.ids_cm, index.inv_cm,
                index.anchors, index.codebooks, 100)
        out = ivf_ops.ivfpq_adc(*args, m=8, nbits=8)
        ref = ivfpq_adc_plain(*args, 8, 8)
    else:
        index = ivf_ops.build_ivf_index(s, 8, lane_pad=128, device="cuda")
        probe = ivf_probe(q, index.centroids, 8)
        args = (q, probe, index.sup_cm, index.ids_cm, index.inv_cm, 100)
        out, ref = ivf_ops.ivf_scan(*args), ivf_scan_plain(*args)
    assert index.list_size == 128 and probe.shape[1] * 128 > 100
    _check_tied(*out, *ref, 1e-4, 1e-5)
    assert (out[1][:, 40:] == -1).all() and torch.isinf(out[0][:, 40:]).all()
    assert (out[1][:, :40] >= 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("Q,N,k", [(16, 70_000, 200), (5, 3_000, 1024),
                                   (3, 700, 1024)])
def test_gpu_knn_kernel_k_above_128_matches_plain(Q, N, k):
    """128 < k <= 1,024: the keyed chunk pass and the shared selection;
    ids may differ from the plain version's only within score ties, and
    k > N leaves -inf / -1 slots."""
    _need_cuda()
    q, s = _knn_data(Q, N, 768, N)
    qd, sd = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
    n0 = knn_topk.launches
    out = knn_topk(qd, sd, k)
    assert knn_topk.launches == n0 + 1
    _check_tied(*out, *knn_topk_reference(qd, sd, k), 1e-5, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exact", "ivf", "ivfpq"])
@pytest.mark.parametrize("k", [1025, 2048])
def test_gpu_selection_above_1024_matches_plain(kind, k):
    """k above one selection round (1,024): the rounds of `select.cuh` give
    the plain version's top k in one (Q, k) output, ids equal up to score
    ties, and -inf / -1 where fewer rows than k exist (exact: N = 1,800;
    IVF: 2 of 32 lists probed, at most 2 x 282 rows)."""
    _need_cuda()
    if kind == "exact":
        q, s = _knn_data(5, 1_800, 768, k)
        qd, sd = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
        n0 = knn_topk.launches
        out = knn_topk(qd, sd, k)
        assert knn_topk.launches == n0 + 1
        _check_tied(*out, *knn_topk_reference(qd, sd, k), 1e-5, 1e-5)
        assert bool((out[1] == -1).any(1).all()) == (k > 1_800)
        return
    q, index = _ivf_index(pq=kind == "ivfpq")
    for nprobe in (32, 2):
        probe = ivf_probe(q, index.centroids, nprobe)
        if kind == "ivf":
            args = (q, probe, index.sup_cm, index.ids_cm, index.inv_cm, k)
            out, ref = ivf_ops.ivf_scan(*args), ivf_scan_plain(*args)
            tol = (1e-5, 1e-5)
        else:
            args = (q, probe, index.codes_cm, index.ids_cm, index.inv_cm,
                    index.anchors, index.codebooks, k)
            out = ivf_ops.ivfpq_adc(*args, m=index.m, nbits=index.nbits)
            ref = ivfpq_adc_plain(*args, index.m, index.nbits)
            tol = (1e-4, 1e-5)
        _check_tied(*out, *ref, *tol)
        assert bool((out[1][:, -1] == -1).all()) == (nprobe == 2)


def _ssd_inputs(Bs, H, nc, Q, P, G, N, seed, valid=None):
    """Kernel-layout inputs on the card; rows at or past ``valid`` of the
    last chunk are zero, as `ssm_full`'s tail padding leaves them."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.normal(size=sh).astype(np.float32))
    x, dt = f(Bs, H, nc, Q, P), torch.nn.functional.softplus(
        f(Bs, H, nc, Q, 1))
    A = -torch.exp(f(H) * 0.3)
    Bm, Cm = f(Bs, G, nc, Q, N) * 0.3, f(Bs, G, nc, Q, N) * 0.3
    grads = (f(Bs, H, nc, Q, P), f(Bs, H, nc, P, N), f(Bs, H, nc, Q, 1))
    if valid is not None:
        S = torch.arange(nc * Q).reshape(nc, Q)
        keep = (S < valid).float()
        x = x * keep[..., None]
        dt = dt * keep[..., None]
        Bm, Cm = Bm * keep[..., None], Cm * keep[..., None]
    return ([t.cuda().contiguous() for t in (x, dt, A, Bm, Cm)],
            [t.cuda().contiguous() for t in grads])


# the phase-3 shapes of chip_smoke.py: the training shape (B 4, 32 heads,
# 8 chunks of 256, P 64, N 128), two groups, a chunk shorter than a tile,
# S = 384 padded to two chunks of 256 by ssm_full, four heads a group,
# six heads a group (not a power of two), a ragged chunk, and N, P that
# are not multiples of 8
SSD_CASES = [(4, 32, 8, 256, 64, 1, 128, None), (2, 8, 2, 256, 64, 2, 128, None),
             (2, 4, 1, 12, 64, 1, 128, None), (2, 32, 2, 256, 64, 1, 128, 384),
             (2, 12, 2, 256, 64, 3, 128, None), (2, 6, 2, 256, 64, 1, 128, None),
             (2, 8, 2, 200, 64, 2, 128, None), (2, 8, 2, 256, 24, 2, 20, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSD_CASES)
def test_gpu_ssd_kernels_match_plain(case):
    """Both kernels against their plain versions evaluated in float64 on
    the same f32 inputs (the f32 plain version's own gA can sit several
    tolerances from it: `bwd_kernel.cu`), rtol / atol 3e-4."""
    _need_cuda()
    *shape, valid = case
    inputs, grads = _ssd_inputs(*shape, seed=sum(shape), valid=valid)
    f64 = lambda ts: [t.double() for t in ts]
    n0 = (ssd_ops.ssd_intra.launches, ssd_ops.ssd_intra_bwd.launches)
    out = ssd_ops.ssd_intra_fwd(*inputs)
    ref = ssd_intra_plain(*inputs)
    for o, r in zip(out, ssd_intra_plain(*f64(inputs))):
        torch.testing.assert_close(o.double(), r, rtol=3e-4, atol=3e-4)
    g = ssd_ops.ssd_intra_bwd(*inputs, ref[2], *grads)
    gr = ssd_intra_bwd_plain(*f64(inputs), *f64([ref[2], *grads]))
    for a, b in zip(g, gr):
        assert a.shape == b.shape and a.dtype == torch.float32
        torch.testing.assert_close(a.double(), b, rtol=3e-4, atol=3e-4)
    assert (ssd_ops.ssd_intra.launches, ssd_ops.ssd_intra_bwd.launches) \
        == (n0[0] + 1, n0[1] + 1)


@pytest.mark.gpu
def test_gpu_ssd_autograd_runs_both_kernels_and_never_the_plain_version(
        monkeypatch):
    _need_cuda()

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ssd_ops, "ssd_intra_plain", refuse)
    monkeypatch.setattr(ssd_ops, "ssd_intra_bwd_plain", refuse)
    inputs, grads = _ssd_inputs(1, 4, 2, 64, 32, 2, 16, seed=3)
    leaves = [t.clone().requires_grad_() for t in inputs]
    n0 = (ssd_ops.ssd_intra.launches, ssd_ops.ssd_intra_bwd.launches)
    y, st, cs = ssd_ops.ssd_intra(*leaves)
    torch.autograd.backward((y, st, cs), grads)
    assert (ssd_ops.ssd_intra.launches, ssd_ops.ssd_intra_bwd.launches) \
        == (n0[0] + 1, n0[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)


@pytest.mark.gpu
def test_gpu_ssd_gradient_allocates_no_per_head_partials():
    """At the training shape one gradient call raises the peak of allocated
    memory above its inputs by at most its outputs plus 64 MB: the group
    sums of gB / gC happen in the kernels, and the scratch is per group."""
    _need_cuda()
    inputs, grads = _ssd_inputs(4, 32, 8, 256, 64, 1, 128, seed=5)
    cs = ssd_ops.ssd_intra_fwd(*inputs)[2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g = ssd_ops.ssd_intra_bwd(*inputs, cs, *grads)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    out = sum(t.numel() * t.element_size() for t in g)
    assert rise <= out + 64 * 2**20, (rise, out)


# ---------------------------------------------------------------------------
# kernel 1 (one launch for k <= 128, histogram and compaction above) and
# kernel 5 (fused cluster path and three-launch path)
# ---------------------------------------------------------------------------

def _knn_support(kind, N, D, seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(N, D)).astype(np.float32)
    if kind == "border ties":
        # one row copied across 64-row tiles and across the row ranges of
        # the blocks (every 530th row is near a range border at N 70,000)
        s[::530] = s[0]
        s[63:66] = s[0]
    elif kind == "all equal":
        s[:] = s[0]
    elif kind == "clustered":
        # near-duplicates of one row: cosines crowd [0.5, 1)
        s = (s[0] + 0.2 * s / np.sqrt(D)).astype(np.float32)
    return s


@pytest.mark.gpu
@pytest.mark.parametrize("kind,Q,N,k", [
    ("gaussian", 1, 70_001, 10), ("gaussian", 33, 70_001, 100),
    ("gaussian", 16, 100_003, 128), ("border ties", 16, 70_000, 10),
    ("border ties", 16, 70_000, 300), ("all equal", 4, 20_000, 100),
    ("all equal", 4, 20_000, 300), ("all equal", 2, 70_000, 2048),
    ("clustered", 16, 70_000, 200), ("clustered", 16, 70_000, 1024)])
def test_gpu_knn_kernel_redesign_cases_match_plain(kind, Q, N, k):
    """N not a multiple of the 64-row tile nor of the row ranges, Q 1 and
    33, ties across tile and range borders, an all-equal support (ties
    everywhere; above k = 128 its candidates overflow the buffer and the
    full-key path answers), near-duplicate rows (above k = 128 the refined
    threshold keeps the candidates within the buffer).  Ties go to the
    lower row id."""
    _need_cuda()
    rng = np.random.default_rng(N + k)
    q = _unit(rng.normal(size=(Q, 768)))
    s = _knn_support(kind, N, 768, N + Q)
    if kind == "clustered":
        q = _unit(s[:Q] + 0.5 * q / np.sqrt(768))
    q, s = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
    n0 = knn_topk.launches
    ks, ki = knn_topk(q, s, k)
    assert knn_topk.launches == n0 + 1
    if k > 128:
        flags = knn_topk.last_overflow.cpu()
        assert flags.all() if kind == "all equal" else not flags.any()
    rs, ri = knn_topk_reference(q, s, k)
    if kind == "clustered":
        # 70,000 cosines within 1e-4 of each other: the kernel's and the
        # plain version's roundings (1e-7) reorder rows at the k-th score, so
        # the scores must agree and every id must point at a row that has
        # its score, once per list
        torch.testing.assert_close(ks, rs, rtol=1e-5, atol=1e-5)
        own = (q @ s.T * torch.rsqrt((s * s).sum(1) + 1e-12)).gather(
            1, ki.long())
        torch.testing.assert_close(own, ks, rtol=1e-5, atol=1e-5)
        assert all(len(set(r.tolist())) == k for r in ki)
    else:
        _check_tied(ks, ki, rs, ri, 1e-5, 1e-5)
    if kind == "all equal":
        assert (ki == torch.arange(k, device="cuda")).all()
    if kind == "border ties":
        # the lower id of every tied score comes first
        for r in range(Q):
            row = ki[r][ki[r] >= 0].cpu().numpy()
            sc = ks[r][: len(row)].cpu().numpy()
            same = sc[1:] == sc[:-1]
            assert (row[1:][same] > row[:-1][same]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 100, 300])
def test_gpu_knn_back_to_back_calls_are_bitwise_equal(k):
    """The one-launch path's ticket counter is reset by the last block, so
    a second call merges again and returns the same bits."""
    _need_cuda()
    q, s = _knn_data(16, 70_000, 768, 9)
    qd, sd = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
    a = knn_topk(qd, sd, k)
    b = knn_topk(qd, sd, k)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    if k <= 128:
        t = next(iter(knn_ops._tickets.values()))
        assert int(t.abs().sum()) == 0


@pytest.mark.gpu
def test_gpu_knn_one_launch_at_the_main_shape():
    """k <= 128 is a single CUDA kernel a call (read with torch.profiler)."""
    _need_cuda()
    [names] = _device_kernels_fresh("""
        q, s = t._knn_data(16, 70_000, 768, 1)
        qd, sd = t.torch.from_numpy(q).cuda(), t.torch.from_numpy(s).cuda()
        fns = [lambda: t.knn_topk(qd, sd, 10)]""")
    assert len(names) == 1 and "knn_scan_kernel" in names[0], names
    q, s = _knn_data(16, 70_000, 768, 1)
    knn_topk(torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda(), 10)
    assert knn_topk.last_cuda_launches == 1


def _pq_synthetic(nbits, C, L, D=128, m=16, short=False, seed=0):
    rng = np.random.default_rng(seed)
    MB = m * nbits // 8
    counts = (np.arange(C) % 4 + 3) if short else np.full(C, L - 3)
    ids = np.full((C, L), -1, np.int32)
    at = 0
    for c, n in enumerate(counts):
        ids[c, :n] = np.arange(at, at + n)
        at += n
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    return dict(codes=t(rng.integers(0, 256, (C, MB, L), dtype=np.uint8)),
                ids=t(ids),
                inv=t(np.where(ids >= 0, 1 + rng.random((C, L)), 0)
                      .astype(np.float32)),
                anchors=t(0.1 * rng.normal(size=(C, D)).astype(np.float32)),
                cb=t(0.1 * rng.normal(size=(m, 2 ** nbits, D // m))
                     .astype(np.float32)),
                cent=t(_unit(rng.normal(size=(C, D))))), m


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("nbits,Q,C,L,P,kk,short", [
    (8, 16, 64, 400, 8, 800, False), (4, 16, 64, 400, 8, 800, False),
    (8, 1, 64, 400, 8, 800, False), (4, 64, 64, 400, 8, 800, False),
    (8, 16, 24, 48, 24, 100, False),      # nprobe = C
    (4, 16, 24, 48, 24, 100, False),
    (8, 16, 32, 64, 2, 100, True),        # short lists: -inf / -1 tail
    (8, 16, 64, 400, 8, 2048, False), (4, 8, 64, 400, 8, 2048, False)])
def test_gpu_ivfpq_both_paths_match_plain(fused, nbits, Q, C, L, P, kk,
                                          short):
    """Shapes the fused launch takes, run on it and on the three launches
    (`_adc_cuda`, the wrapper's launch on a path the test picks)."""
    _need_cuda()
    idx, m = _pq_synthetic(nbits, C, L, short=short, seed=C + L + kk)
    rng = np.random.default_rng(Q + kk)
    q = torch.from_numpy(_unit(rng.normal(size=(Q, 128)))).cuda()
    probe = ivf_probe(q, idx["cent"], P)
    args = (q, probe, idx["codes"], idx["ids"], idx["inv"], idx["anchors"],
            idx["cb"], kk)
    assert ivf_ops.fused_fits(m, nbits, idx["codes"].shape[1], L, P, kk)
    n0 = ivf_ops.ivfpq_adc.launches
    out = ivf_ops._adc_cuda(*args, m=m, nbits=nbits, fused=fused)
    assert ivf_ops.ivfpq_adc.launches == n0 + 1
    assert ivf_ops.ivfpq_adc.last_cuda_launches == (
        1 if fused else 2 + -(-kk // 1024))
    _check_tied(*out, *ivfpq_adc_plain(*args, m, nbits), 1e-4, 1e-5)
    if short:
        assert (out[1] == -1).any() and torch.isinf(out[0][out[1] < 0]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("nbits,Q", [(8, 1), (8, 64), (4, 1), (4, 64)])
def test_gpu_ivfpq_shape_chooses_the_three_launch_path(nbits, Q):
    """nprobe = C on 64 lists of 400: the keys exceed a block's shared
    memory, so the launcher takes the three launches; kk > 2,048 too."""
    _need_cuda()
    shapes = ((64, 800), (8, 3000))
    setup = f"""
        idx, m = t._pq_synthetic({nbits}, 64, 400)
        q = t.torch.from_numpy(t._unit(t.np.random.default_rng({Q}).normal(
            size=({Q}, 128)))).cuda()
        fns = [lambda P=P, kk=kk: t.ivf_ops.ivfpq_adc(
                   q, t.ivf_probe(q, idx["cent"], P), idx["codes"],
                   idx["ids"], idx["inv"], idx["anchors"], idx["cb"], kk,
                   m=m, nbits={nbits}) for P, kk in {shapes}]"""
    profiled = _device_kernels_fresh(setup)
    idx, m = _pq_synthetic(nbits, 64, 400)
    MB = idx["codes"].shape[1]
    q = torch.from_numpy(_unit(np.random.default_rng(Q).normal(
        size=(Q, 128)))).cuda()
    for (P, kk), kernels in zip(shapes, profiled):
        probe = ivf_probe(q, idx["cent"], P)
        args = (q, probe, idx["codes"], idx["ids"], idx["inv"],
                idx["anchors"], idx["cb"], kk)
        assert not ivf_ops.fused_fits(m, nbits, MB, 400, P, kk)
        out = ivf_ops.ivfpq_adc(*args, m=m, nbits=nbits)
        names = " ".join(kernels)
        assert "adc_scan_kernel" in names and "adc_fused" not in names
        assert ivf_ops.ivfpq_adc.last_cuda_launches == 2 + -(-kk // 1024)
        _check_tied(*out, *ivfpq_adc_plain(*args, m, nbits), 1e-4, 1e-5)
        with pytest.raises(ValueError, match="fused path"):
            ivf_ops._adc_cuda(*args, m=m, nbits=nbits, fused=True)


@pytest.mark.gpu
def test_gpu_ivfpq_fused_is_one_launch_and_checks_cluster_occupancy():
    """At the serving shape the fused path is one CUDA kernel; the
    occupancy check reports resident clusters there and none for a block
    larger than the shared memory an SM has."""
    _need_cuda()
    smem, clusters = ivf_ops.fused_plan(64, 8, 64, 400, 8, 800)
    assert smem == ivf_ops.fused_smem_bytes(64, 8, 64, 400, 8, 800)
    assert clusters >= 16
    assert ivf_ops.fused_plan(64, 8, 64, 400, 64, 800)[1] == 0
    [kernels] = _device_kernels_fresh("""
        idx, m = t._pq_synthetic(8, 64, 400, D=768, m=64)
        q = t.torch.from_numpy(t._unit(t.np.random.default_rng(2).normal(
            size=(16, 768)))).cuda()
        probe = t.ivf_probe(q, idx["cent"], 8)
        fns = [lambda: t.ivf_ops.ivfpq_adc(
            q, probe, idx["codes"], idx["ids"], idx["inv"], idx["anchors"],
            idx["cb"], 800, m=m, nbits=8)]""")
    assert len(kernels) == 1 and "adc_fused_kernel" in kernels[0], kernels
    idx, m = _pq_synthetic(8, 64, 400, D=768, m=64)
    q = torch.from_numpy(_unit(np.random.default_rng(2).normal(
        size=(16, 768)))).cuda()
    probe = ivf_probe(q, idx["cent"], 8)
    ivf_ops.ivfpq_adc(q, probe, idx["codes"], idx["ids"], idx["inv"],
                      idx["anchors"], idx["cb"], 800, m=m, nbits=8)
    assert ivf_ops.ivfpq_adc.last_cuda_launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["knn20-ivf", "knn20-ivfpq@m=8"])
def test_gpu_degraded_routes_match_the_cpu_router(spec):
    """`route_fused(degrade=L)` for L = 1-3 on a small CUDA router (kernel 4
    or 5 at nprobe 4, 4, 2 and re-rank 8, 0, 0) against the same router on
    the CPU (the plain versions): equal choices, utilities at 1e-5, the
    kernel launched each call, ``nprobe`` / ``rerank`` restored."""
    _need_cuda()
    from repro_torch.core.dataset import RoutingDataset
    from repro_torch.core.routers import make_router
    from repro_torch.serving.encoder import QueryEncoder
    from repro_torch.serving.router_service import RouterService
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(8, 64)) * 3
    topic = rng.integers(0, 8, 3000)
    X = (centers[topic] + rng.normal(size=(3000, 64))).astype(np.float32)
    S = np.clip(rng.uniform(0.2, 1, (8, 3))[topic]
                + rng.normal(0, 0.05, (3000, 3)), 0, 1).astype(np.float32)
    C = np.tile(rng.uniform(0.001, 0.01, 3), (3000, 1)).astype(np.float32)
    names = ["a", "b", "c"]
    ds = RoutingDataset("d", X, S, C, names)
    Q = (centers[rng.integers(0, 8, 16)]
         + rng.normal(size=(16, 64))).astype(np.float32)
    lam = np.linspace(0, 50, 16).astype(np.float32)
    svcs = {dev: RouterService(make_router(spec, device=dev).fit(ds),
                               {m: None for m in names},
                               encoder=QueryEncoder(device="cpu"))
            for dev in ("cuda", "cpu")}
    wrapper = (ivf_ops.ivfpq_adc if "ivfpq" in spec else ivf_ops.ivf_scan)
    saved = (svcs["cuda"].router.nprobe, svcs["cuda"].router.rerank)
    for level in (1, 2, 3):
        n0 = wrapper.launches
        g = svcs["cuda"].route_fused(Q, lam, degrade=level)
        assert wrapper.launches == n0 + 1
        c = svcs["cpu"].route_fused(Q, lam, degrade=level)
        np.testing.assert_array_equal(g[0], c[0])
        for a, b in zip(g[1:3], c[1:3]):
            np.testing.assert_allclose(a, b, atol=1e-5)
        assert (svcs["cuda"].router.nprobe,
                svcs["cuda"].router.rerank) == saved


@pytest.mark.gpu
def test_gpu_stats_json_takes_cuda_tensors():
    _need_cuda()
    import json
    from repro_torch.serving.router_service import to_jsonable
    odd = {"n": torch.tensor(7, device="cuda"),
           "v": torch.arange(3, device="cuda").float()}
    assert json.loads(json.dumps(to_jsonable(odd))) == {"n": 7,
                                                        "v": [0.0, 1.0, 2.0]}


# ---------------------------------------------------------------------------
# the streaming tier: kernels 4 and 5 over the probed delta sub-lists
# ---------------------------------------------------------------------------

def _delta_case(pq, tier, Q=16, nprobe=8, nbits=8):
    """A small CUDA index wrapped in a `DynamicIVFIndex` whose tier is:
    ``few`` (one or two rows near each centroid), ``per_list`` (64 rows near
    each probed centroid), ``skewed`` (4,096 rows in one probed list) or
    ``empty`` (rows only in lists no query probes).  Returns (queries,
    probe, base, snapshot)."""
    q, index = _ivf_index(pq, nbits=nbits)
    q = q[:Q].contiguous()
    rng = np.random.default_rng(len(tier) + 10 * pq)
    probe = ivf_probe(q, index.centroids, nprobe)
    cent = index.centroids_h
    probed = sorted(set(probe.cpu().numpy().ravel().tolist()))
    near = lambda c, n: (cent[c] * 3 + 0.05 * rng.normal(  # noqa: E731
        size=(n, cent.shape[1]))).astype(np.float32)
    if tier == "few":
        rows = np.concatenate([near(c, 1 + c % 2) for c in range(len(cent))])
    elif tier == "per_list":
        rows = np.concatenate([near(c, 64) for c in probed])
    elif tier == "skewed":
        rows = near(probed[0], 4096)
    else:
        free = [c for c in range(len(cent)) if c not in probed]
        rows = np.concatenate([near(c, 8) for c in free])
        # split lists can have near-equal centroids: keep the rows that are
        # assigned to an unprobed list
        rn = rows / np.linalg.norm(rows, axis=1, keepdims=True)
        rows = rows[~np.isin(np.argmax(rn @ cent.T, axis=1), probed)]
    dyn = ivf_ops.DynamicIVFIndex(index)
    dyn.append(rows)
    snap = dyn.fused_state()
    lens = snap.delta.off[1:] - snap.delta.off[:-1]
    hit = lens[probe.long()].sum().item()
    assert (hit == 0) == (tier == "empty"), (tier, hit)
    return q, probe, index, snap


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["few", "per_list", "skewed", "empty"])
@pytest.mark.parametrize("k", [100, 2100])
def test_gpu_ivf_scan_delta_sublists_match_plain(tier, k):
    """Kernel 4 with the probed delta sub-lists in the same launch: against
    its plain version, two calls bitwise equal, one CUDA launch at k <=
    2,048 (above it the scan and the selection rounds)."""
    _need_cuda()
    q, probe, base, snap = _delta_case(False, tier)
    args = (q, probe, base.sup_cm, base.ids_cm, base.inv_cm, k)
    out = ivf_ops.ivf_scan(*args, delta=snap.delta)
    launches = ivf_ops.ivf_scan.last_cuda_launches
    again = ivf_ops.ivf_scan(*args, delta=snap.delta)
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])
    assert launches == (1 if k <= 2048 else 1 + -(-k // 1024))
    _check_tied(*out, *ivf_scan_plain(*args, snap.delta), 1e-5, 1e-5)
    if tier == "per_list":
        assert bool((out[1] >= snap.delta.n_base).any())


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["few", "per_list", "skewed", "empty"])
@pytest.mark.parametrize("nbits", [8, 4])
def test_gpu_ivfpq_adc_delta_sublists_match_plain(tier, nbits):
    """Kernel 5 with the probed delta sub-lists on the path the shape picks
    and on the three launches: against the plain version, bitwise equal
    on a second call, one CUDA launch on the fused path."""
    _need_cuda()
    q, probe, base, snap = _delta_case(True, tier, nbits=nbits)
    d = snap.delta
    args = (q, probe, base.codes_cm, base.ids_cm, base.inv_cm, base.anchors,
            base.codebooks, 400)
    ref = ivfpq_adc_plain(*args, base.m, nbits, d)
    fits = ivf_ops.fused_fits(base.m, nbits, base.codes_cm.shape[1],
                              base.list_size, probe.shape[1], 400, d.lmax)
    assert fits == (tier != "skewed")
    for fused in ([True, False] if fits else [False]):
        out = ivf_ops._adc_cuda(*args, m=base.m, nbits=nbits, fused=fused,
                                delta=d)
        assert ivf_ops.ivfpq_adc.last_cuda_launches == (1 if fused else 3)
        again = ivf_ops._adc_cuda(*args, m=base.m, nbits=nbits, fused=fused,
                                  delta=d)
        assert torch.equal(out[0], again[0]) and torch.equal(out[1],
                                                             again[1])
        _check_tied(*out, *ref, 1e-4, 1e-5)
    out = ivf_ops.ivfpq_adc(*args, m=base.m, nbits=nbits, delta=d)
    _check_tied(*out, *ref, 1e-4, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["knn20-ivf", "knn20-ivfpq@m=8"])
def test_gpu_background_compaction_swaps_under_routes(spec, monkeypatch):
    """Routes on one thread while another observes in batches past
    ``delta_cap`` with background compaction: no route fails, and one
    route lands during the rebuild (the rebuild waits for it).  After the
    join (and a compaction of the rows appended meanwhile) the base equals
    a fresh build over ``all_rows()`` byte for byte, and routes bitwise as
    a router serving that build."""
    _need_cuda()
    import threading
    from repro_torch.core.dataset import RoutingDataset
    from repro_torch.core.routers import make_router
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(8, 64)) * 3
    names = ["a", "b", "c"]

    def data(n):
        topic = rng.integers(0, 8, n)
        X = (centers[topic] + rng.normal(size=(n, 64))).astype(np.float32)
        S = rng.uniform(0.2, 1, (n, 3)).astype(np.float32)
        return X, S, np.full((n, 3), 0.005, np.float32)

    X, S, C = data(3000)
    r = make_router(spec, device="cuda", delta_cap=200).fit(
        RoutingDataset("d", X, S, C, names))
    Q = data(16)[0]
    lam = np.linspace(0, 10, 16).astype(np.float32)
    in_build, routed = threading.Event(), threading.Event()
    build = ivf_ops.DynamicIVFIndex._build_base

    def held_build(self, rows):
        in_build.set()
        routed.wait(60)
        return build(self, rows)

    monkeypatch.setattr(ivf_ops.DynamicIVFIndex, "_build_base", held_build)
    stop, errors, during = threading.Event(), [], [0]

    def routes():
        while not stop.is_set():
            try:
                started = in_build.is_set() and r._ivf.recluster_pending
                r.serve_fused(Q, lam)
                if started and r._ivf.recluster_pending:
                    during[0] += 1
                    routed.set()
            except Exception as exc:          # noqa: BLE001
                errors.append(exc)
                routed.set()
                return

    t = threading.Thread(target=routes)
    t.start()
    for _ in range(6):
        r.partial_fit(*data(64), recluster="background")
    r.join_recluster()
    stop.set()
    t.join()
    monkeypatch.undo()
    assert not errors, errors
    assert r._ivf.reclusters >= 1 and during[0] >= 1
    r._ivf.recluster()
    assert r._ivf.delta_rows == 0
    dyn = r._ivf
    build = (ivf_ops.build_ivfpq_index if dyn.is_pq
             else ivf_ops.build_ivf_index)
    base = build(dyn.all_rows(), device="cuda", **dyn.build_kw)
    for f in ("centroids_h", "ids_h", "inv_h",
              "codes_h" if dyn.is_pq else "sup_h"):
        assert np.array_equal(getattr(dyn.base, f), getattr(base, f)), f
    fresh = make_router(spec, device="cuda").fit(
        RoutingDataset("d", X, S, C, names))
    fresh._X, fresh._S, fresh._C, fresh._ivf = r._X, r._S, r._C, base
    fresh._dev = {}
    for a, b in zip(r.serve_fused(Q, lam), fresh.serve_fused(Q, lam)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the paper's evaluation on the card: learned routers and the self-query
# ---------------------------------------------------------------------------

def _eval_data(n=300):
    from repro_torch.data.prices import ROUTERBENCH
    from repro_torch.data.synthetic import GenSpec, generate
    return generate(GenSpec("small", ROUTERBENCH["RouterBench"],
                            n_queries=n, ambient_dim=64, seed=1))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["linear", "linear_mf", "mlp", "mlp_mf",
                                  "graph10", "attn10", "dattn10"])
def test_gpu_learned_fit_matches_cpu_forward(spec):
    """A fit on the card (2 epochs), its state copied to a CPU router: the
    CPU forward at the card's weights within 1e-4 (f32 products in another
    order; TF32 is off by default); the loss finite."""
    _need_cuda()
    from repro_torch.core.routers import make_router
    ds = _eval_data()
    kw = {} if spec == "linear" else {"epochs": 2}
    gr = make_router(spec, device="cuda", **kw).fit(ds)
    cr = make_router(spec, device="cpu", **kw)
    cr.load_state_dict(gr.state_dict())
    X = ds.part("test")[0]
    (gs, gc), (cs, cc) = gr.predict_utility(X), cr.predict_utility(X)
    scale = getattr(gr, "_c_scale", 1.0)
    assert np.abs(gs - cs).max() <= 1e-4 and np.abs(gc - cc).max() <= 1e-4 * scale
    if spec != "linear":
        assert all(np.isfinite(gr.train_losses))


@pytest.mark.gpu
@pytest.mark.parametrize("N,k", [(1400, 11), (1400, 101), (5040, 11)])
def test_gpu_self_query_matches_plain(N, k):
    """Kernel 1 with the support as its own queries (Q = N, the graph and
    attentive fits' exclude_self search): scores and ids against the plain
    version outside ties, and each row's top-1 is itself."""
    _need_cuda()
    s = torch.from_numpy(_knn_data(1, N, 768, N)[1]).cuda()
    q = s / s.norm(dim=1, keepdim=True)
    n0 = knn_topk.launches
    ks, ki = knn_topk(q, s, k)
    assert knn_topk.launches == n0 + 1
    _check_tied(ks, ki, *knn_topk_reference(q, s, k), 1e-5, 1e-5)
    assert (ki[:, 0].cpu() == torch.arange(N, dtype=torch.int32)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["graph10", "attn10"])
def test_gpu_neighbour_fit_launches_kernel_not_plain(spec, monkeypatch):
    _need_cuda()
    from repro_torch.core.routers import make_router

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(knn_ops, "knn_topk_reference", refuse)
    n0 = knn_topk.launches
    r = make_router(spec, epochs=1, device="cuda").fit(_eval_data())
    assert knn_topk.launches == n0 + 1          # the fit's self-query
    r.predict_utility(_eval_data().part("test")[0])
    assert knn_topk.launches == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["mlp", "graph10", "attn10"])
def test_gpu_graphed_fit_matches_eager_fit(spec, monkeypatch):
    """12 epochs over 700 train rows: the full batches replayed from the
    CUDA graph (after three eager ones; each epoch's partial batch eager)
    against the same fit with every step eager on the card.  The same
    kernels in the same order: losses and predictions within 1e-5."""
    _need_cuda()
    from repro_torch.core.routers import make_router
    from repro_torch.core.routers import nn_utils
    ds = _eval_data(1000)
    gr = make_router(spec, epochs=12, device="cuda").fit(ds)
    monkeypatch.setattr(nn_utils._GraphedStep, "WARMUP", 10**9)
    er = make_router(spec, epochs=12, device="cuda").fit(ds)
    for a, b in zip(gr.train_losses, er.train_losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    X = ds.part("test")[0]
    for a, b in zip(gr.predict_utility(X), er.predict_utility(X)):
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(b).max())


# ---------------------------------------------------------------------------
# kernel 2b (the flash attention backward), head dim 112, and the model
# families that train through them
# ---------------------------------------------------------------------------

def _bwd_err(got, want, dtype):
    """Largest |got - want| over (|want| 2^-8 + 2e-5 in bf16, else 2e-5) is
    at most 1: the plain version's f32 gradient is the yardstick (see
    chip_smoke.py's `attn_err`), with bf16's own rounding allowed."""
    d = (got.float() - want).abs()
    lim = torch.full_like(want, 2e-5 if dtype == torch.float32 else 1e-2)
    if dtype == torch.bfloat16:
        lim = torch.maximum(lim, want.abs() * 2.0 ** -8 + 2e-5)
    return float((d / lim).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,S,KV,G,hd,causal,window", [
    (torch.float32, 2, 130, 2, 1, 64, True, 0),
    (torch.float32, 1, 200, 1, 5, 80, True, 48),
    (torch.float32, 1, 100, 1, 12, 112, False, 0),
    (torch.float32, 1, 257, 2, 1, 128, True, 64),
    (torch.bfloat16, 2, 130, 2, 5, 112, True, 0),
    (torch.bfloat16, 1, 300, 1, 12, 128, True, 100),
    (torch.bfloat16, 2, 96, 2, 1, 80, False, 0),
    # the tensor-core design's edges: danube's training shape at B 1; hd
    # 112 windowed, S not a multiple of 64; 8 query tiles x 3 heads through
    # one dkdv block's two-stage ring, ragged last tile; the G-split path
    # (G 12 over 5 blocks a KV head on 132 SMs, partials summed in order)
    (torch.bfloat16, 1, 4096, 8, 4, 80, True, 4096),
    (torch.bfloat16, 1, 333, 2, 4, 112, True, 100),
    (torch.float32, 1, 450, 1, 3, 80, True, 0),
    (torch.bfloat16, 1, 1000, 4, 12, 128, True, 0),
])
def test_gpu_flash_backward_matches_plain(dtype, B, S, KV, G, hd, causal,
                                          window):
    """Kernel 2b through the autograd Function (forward with lse, then the
    backward kernels) against autograd through the plain version in f32 on
    the same values; f32 limit 2e-5, bf16 1e-2 or its own rounding.  A
    second backward gives the same bits (no atomics)."""
    _need_cuda()
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain)
    g = torch.Generator(device="cuda").manual_seed(S + hd + G)
    H = KV * G
    q = torch.randn(B, S, H, hd, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(B, S, KV, hd, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    do = torch.randn(B, S, H, hd, device="cuda", generator=g).to(dtype)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n0 = (fops.flash_attention.launches,
              fops.flash_attention_bwd.launches)
        out = fops.flash_attention(*leaves, causal=causal, window=window)
        out.backward(do)
        assert (fops.flash_attention.launches,
                fops.flash_attention_bwd.launches) == (n0[0] + 1, n0[1] + 1)
        grads.append([t.grad for t in leaves])
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     do.float(), causal=causal,
                                     window=window)
    for a, b, w in zip(grads[0], grads[1], want):
        assert a.dtype == dtype and torch.equal(a, b)
        assert _bwd_err(a, w, dtype) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 5e-2)])
def test_gpu_attention_kernels_at_head_dim_112(dtype, tol):
    """zamba2-7b's shared block: d_model 3,584 / 32 heads = 112."""
    _need_cuda()
    q, k, v = (torch.from_numpy(x).cuda().to(dtype)
               for x in _attn_data(2, 150, 32, 32, 112, 112))
    torch.testing.assert_close(
        flash_attention(q, k, v, causal=True, window=0).float(),
        flash_attention_reference(q, k, v, causal=True, window=0).float(),
        rtol=tol, atol=tol)
    q, ck, cv = (torch.from_numpy(x).cuda().to(dtype)
                 for x in _decode_data(4, 300, 32, 32, 112, 7))
    pos = torch.tensor([0, 63, 64, 299], dtype=torch.int32, device="cuda")
    torch.testing.assert_close(
        decode_attention(q, ck, cv, pos).float(),
        decode_attention_reference(q, ck, cv, pos).float(), rtol=tol,
        atol=tol)


def _reduced_step(name, device, seed=0):
    """One AdamW step of ``name``'s reduced config on ``device`` from the
    same CPU-drawn weights and batch: (metrics, parameters after)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step
    cfg = reduced(get_config(name))
    lm = M.init_params(cfg, seed=seed, device="cpu").to(device)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65))).to(
        device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    # N(0, 1) patches or frames (80 rows) for a front end
    if cfg.frontend == "vision":
        batch["patches"] = torch.from_numpy(rng.normal(size=(
            2, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)).to(
            device)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rng.normal(size=(
            2, 80, cfg.frontend_dim)).astype(np.float32)).to(device)
    step = make_train_step(cfg, O.OptConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=4))
    met = step(lm, O.init(dict(lm.named_parameters())), batch)
    return met, {n: p.detach() for n, p in lm.named_parameters()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen1.5-32b", "starcoder2-15b",
                                  "llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b", "zamba2-7b"])
def test_gpu_new_family_train_step_matches_cpu(name):
    """A reduced train step on the card (flash forward and backward, MoE,
    MLA, the shared block, the SSD kernels) against the same step on the
    CPU's plain versions: loss and grad norm within 1e-4, and every
    parameter after the AdamW step within 2e-3 (an lr of 1e-3 bounds a
    step; Adam's normalised update of a near-zero gradient may flip)."""
    _need_cuda()
    gm, gp = _reduced_step(name, "cuda")
    cm, cp = _reduced_step(name, "cpu")
    for key in ("loss", "aux_loss", "grad_norm"):
        torch.testing.assert_close(gm[key].cpu(), cm[key], rtol=1e-4,
                                   atol=1e-4)
    for n, p in cp.items():
        torch.testing.assert_close(gp[n].cpu(), p, rtol=0, atol=2e-3,
                                   msg=n)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b"])
def test_gpu_moe_train_step_is_bitwise_repeatable(name):
    """Two runs of the same reduced step on the card give the same bits:
    the MoE combine sums the k choices in a fixed order and the flash
    backward has no atomics."""
    _need_cuda()
    a_met, a = _reduced_step(name, "cuda", seed=4)
    b_met, b = _reduced_step(name, "cuda", seed=4)
    assert torch.equal(a_met["loss"], b_met["loss"])
    assert torch.equal(a_met["grad_norm"], b_met["grad_norm"])
    for n in a:
        assert torch.equal(a[n], b[n]), n


@pytest.mark.gpu
def test_gpu_attention_training_never_takes_the_plain_version(monkeypatch):
    """A reduced starcoder2 step on the card runs both flash kernels and
    never reaches the plain forward or backward with a CUDA tensor."""
    _need_cuda()
    import repro_torch.kernels.flash_attention.ops as fops

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(fops, "flash_attention_reference", refuse)
    monkeypatch.setattr(fops, "flash_attention_bwd_plain", refuse)
    n0 = (fops.flash_attention.launches, fops.flash_attention_bwd.launches)
    met, _ = _reduced_step("starcoder2-15b", "cuda")
    assert torch.isfinite(met["loss"])
    assert fops.flash_attention.launches - n0[0] >= 2
    assert fops.flash_attention_bwd.launches - n0[1] == 2


# ---------------------------------------------------------------------------
# the front ends: cross attention (Sq != Sk, no mask) through kernels 2, 2b
# and 3, and the reduced vision and encoder-decoder models on the card
# ---------------------------------------------------------------------------

def _cross_bwd_err(got, want, dtype):
    """`_bwd_err` with chip_smoke.py's f32 limit, 2e-5 + 1e-5 |want|: a
    cross key's gradient sums over every query (2,048 at seamless's
    training shape), so it grows past the sums of the causal cases."""
    if dtype == torch.bfloat16:
        return _bwd_err(got, want, dtype)
    d = (got.float() - want).abs()
    return float((d / (2e-5 + 1e-5 * want.abs())).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk", [(2, 2048, 1500), (4, 1, 1500),
                                     (1, 96, 40)])
def test_gpu_cross_attention_kernels_match_plain(dtype, B, Sq, Sk):
    """seamless-m4t-medium's cross attention (H = KV = 16, hd 64, no mask):
    the training shape (2,048 decoder tokens over 1,500 encoder rows), the
    recompute decode (Sq 1) and Sk under one 64-row tile.  Kernel 2
    against the plain forward (f32 2e-5, bf16 5e-2); kernel 2b through the
    autograd Function against the plain backward (`_cross_bwd_err`)."""
    _need_cuda()
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain)
    g = torch.Generator(device="cuda").manual_seed(B + Sq + Sk)
    q = torch.randn(B, Sq, 16, 64, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(B, Sk, 16, 64, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    do = torch.randn(B, Sq, 16, 64, device="cuda", generator=g).to(dtype)
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    n0 = (fops.flash_attention.launches, fops.flash_attention_bwd.launches)
    out = fops.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(
        out.float(), flash_attention_reference(q, k, v, causal=False).float(),
        rtol=tol, atol=tol)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fops.flash_attention(*leaves, causal=False).backward(do)
    assert (fops.flash_attention.launches,
            fops.flash_attention_bwd.launches) == (n0[0] + 2, n0[1] + 1)
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     do.float(), causal=False)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == dtype
        assert _cross_bwd_err(leaf.grad, w, dtype) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 5e-2)])
def test_gpu_cross_decode_kernel_matches_plain(dtype, tol):
    """The cached cross decode: kernel 3 over 1,500 encoder rows with
    every slot at position 1,499 (the whole cache), H = KV = 16, hd 64."""
    _need_cuda()
    q, ck, cv = (torch.from_numpy(x).cuda().to(dtype)
                 for x in _decode_data(4, 1500, 16, 16, 64, 1500))
    pos = torch.full((4,), 1499, dtype=torch.int32, device="cuda")
    n0 = decode_attention.launches
    out = decode_attention(q, ck, cv, pos)
    assert decode_attention.launches == n0 + 1
    torch.testing.assert_close(
        out.float(), decode_attention_reference(q, ck, cv, pos).float(),
        rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["internvl2-76b", "seamless-m4t-medium"])
def test_gpu_front_end_train_step_matches_cpu(name, monkeypatch):
    """A reduced train step with N(0, 1) patches or frames on the card
    (the encoder, the cross attention and the patch prefix through kernels
    2 and 2b, never their plain versions) against the same step on the
    CPU, with `test_gpu_new_family_train_step_matches_cpu`'s limits."""
    _need_cuda()
    import repro_torch.kernels.flash_attention.ops as fops
    cm, cp = _reduced_step(name, "cpu")

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(fops, "flash_attention_reference", refuse)
    monkeypatch.setattr(fops, "flash_attention_bwd_plain", refuse)
    n0 = fops.flash_attention_bwd.launches
    gm, gp = _reduced_step(name, "cuda")
    # two decoder layers, and for seamless their cross attention and the
    # encoder's layer
    n_attn = 5 if name == "seamless-m4t-medium" else 2
    assert fops.flash_attention_bwd.launches - n0 == n_attn
    for key in ("loss", "aux_loss", "grad_norm"):
        torch.testing.assert_close(gm[key].cpu(), cm[key], rtol=1e-4,
                                   atol=1e-4)
    for n, p in cp.items():
        torch.testing.assert_close(gp[n].cpu(), p, rtol=0, atol=2e-3,
                                   msg=n)


@pytest.mark.gpu
def test_gpu_cross_decode_paths_match_cpu():
    """reduced seamless-m4t-medium decoding 12 tokens of 2 slots over 50
    encoder rows on the card: the cached cross K / V (kernel 3 at position
    Se - 1, two decoder layers a step) and the per-step recompute (kernel 2
    at Sq 1) against the CPU's plain decode, 1e-4."""
    _need_cuda()
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import model as M
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(1, 512, (2, 12)))
    frames = torch.from_numpy(rng.normal(size=(2, 50, 128)).astype(
        np.float32))

    def decode(cfg, device):
        lm = M.init_params(cfg, seed=3, device="cpu").to(device)
        enc = M.encode(lm, cfg, frames.to(device))
        caches = M.init_caches(cfg, 2, 16, device, enc_len=50)
        if cfg.cross_kv_cache:
            M.fill_cross_cache(lm, cfg, caches, enc)
        out = []
        for t in range(12):
            logits, caches = M.decode_step(
                lm, cfg, caches, toks[:, t:t + 1].to(device),
                torch.full((2,), t, device=device),
                enc_out=None if cfg.cross_kv_cache else enc)
            out.append(logits.cpu())
        return torch.stack(out, 1)
    for cached in (True, False):
        cfg = reduced(get_config("seamless-m4t-medium")).replace(
            cross_kv_cache=cached)
        n0 = (decode_attention.launches, fops.flash_attention.launches)
        with torch.no_grad():
            got = decode(cfg, "cuda")
        d3 = decode_attention.launches - n0[0]
        d2 = fops.flash_attention.launches - n0[1]
        # self decode 2 a step; cached cross 2 more a step, or the encoder's
        # layer plus 2 recomputes a step through kernel 2
        assert (d3, d2) == ((48, 1) if cached else (24, 1 + 24))
        torch.testing.assert_close(got, decode(cfg, "cpu"), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the tooling on the card: kernel 4's query tiles, the sync counter
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["Q=1", "Q=16", "Q=17", "Q=64",
                                  "shared probes", "short lists", "k=2049"])
def test_gpu_ivf_query_tiles_are_bitwise_equal(kind):
    """Kernel 4 at each instantiated query tile (8, 16, 32, 64) gives the
    bits of tile 16, the tile launched is the one asked for, and with none
    asked for the batch's (`block_q_for`)."""
    _need_cuda()
    (_, sup, ids, inv), q, probe, k = _ivf_tile_case(kind)
    args = (q, probe, sup, ids, inv, k)
    base = ivf_ops.ivf_scan(*args, block_q=16)
    out = ivf_ops.ivf_scan(*args)
    assert ivf_ops.ivf_scan.last_block_q == ivf_ops.block_q_for(len(q))
    assert torch.equal(out[0], base[0]) and torch.equal(out[1], base[1])
    for bq in ivf_ops.IVF_BLOCK_QS:
        out = ivf_ops.ivf_scan(*args, block_q=bq)
        assert ivf_ops.ivf_scan.last_block_q == bq
        assert torch.equal(out[0], base[0]) and torch.equal(out[1], base[1])
    with pytest.raises(ValueError, match="block_q"):
        ivf_ops.ivf_scan(*args, block_q=12)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["few", "per_list", "skewed"])
def test_gpu_ivf_query_tiles_over_delta_sublists(tier):
    _need_cuda()
    q, probe, base, snap = _delta_case(False, tier, Q=33)
    args = (q, probe, base.sup_cm, base.ids_cm, base.inv_cm, 100)
    ref = ivf_ops.ivf_scan(*args, delta=snap.delta)
    for bq in ivf_ops.IVF_BLOCK_QS:
        out = ivf_ops.ivf_scan(*args, delta=snap.delta, block_q=bq)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def _tooling_router(spec):
    from repro_torch.core.dataset import RoutingDataset
    from repro_torch.core.routers import make_router
    rng = np.random.default_rng(11)
    X = rng.normal(size=(3000, 64)).astype(np.float32)
    S = rng.uniform(0.2, 1, (3000, 3)).astype(np.float32)
    C = rng.uniform(0.001, 0.01, (3000, 3)).astype(np.float32)
    ds = RoutingDataset("d", X, S, C, ["a", "b", "c"])
    Q = rng.normal(size=(16, 64)).astype(np.float32)
    return make_router(spec, device="cuda").fit(ds), Q


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["knn10", "knn20-ivf", "knn20-ivfpq@m=8"])
def test_gpu_sync_counter_on_a_route(spec):
    """`route_fused` under `SyncCounter`: the syncs a route makes sit on
    lines the R1 gate lets through on an allow-host pragma (the end-of-
    batch copy among them), and five more waves grow no cache."""
    _need_cuda()
    from repro_torch.analysis.sanitizers import (CacheCounter, SyncCounter,
                                                 allowed_by_pragma,
                                                 port_caches)
    from repro_torch.serving.router_service import RouterService
    r, Q = _tooling_router(spec)
    svc = RouterService(r, {m: None for m in ("a", "b", "c")})
    lam = np.linspace(0, 5, 16).astype(np.float32)
    first = svc.route_fused(Q, lam)
    torch.cuda.synchronize()
    with SyncCounter() as sc:
        out = svc.route_fused(Q, lam)
    assert sc.records, "a route copies its result to the host"
    assert allowed_by_pragma(sc.records) == [], sc.by_site()
    assert any("knn.py" in s for s in sc.by_site()), sc.by_site()
    np.testing.assert_array_equal(out[0], first[0])
    cc = CacheCounter(port_caches({spec: r}))
    cc.snapshot()
    for _ in range(5):
        svc.route_fused(Q, lam)
    assert cc.growth() == {}


@pytest.mark.gpu
def test_gpu_policy_tiles_reach_the_kernels():
    """A policy's block_q is the tile kernel 4 launches; a probe_chunk
    leaves kernel 5 on the path its shape picks; routes are unchanged."""
    _need_cuda()
    from repro_torch.core.routers.dispatch import DispatchPolicy
    lam = np.full(16, 0.5, np.float32)
    r, Q = _tooling_router("knn20-ivf")
    base = r.serve_fused(Q, lam)
    r.dispatch_policy = DispatchPolicy(cells={}, tiles={"ivf": {"block_q": 64}})
    got = r.serve_fused(Q, lam)
    assert ivf_ops.ivf_scan.last_block_q == 64
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a, b)
    r, Q = _tooling_router("knn20-ivfpq@m=8")
    base = r.serve_fused(Q, lam)
    assert ivf_ops.ivfpq_adc.last_cuda_launches == 1
    r.dispatch_policy = DispatchPolicy(cells={},
                                       tiles={"ivfpq": {"probe_chunk": 2}})
    got = r.serve_fused(Q, lam)
    assert ivf_ops.ivfpq_adc.last_cuda_launches == 1
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_gpu_autotune_router_times_kernel_4_and_round_trips(tmp_path):
    """`autotune_router` on the card: on IVF each tile's device time of
    kernel 4 alone (the neighbours bitwise equal, asserted by the sweep),
    on IVF-PQ one search standing for every candidate; the tuned tiles
    saved with the artifact load back, route equal and launch the chosen
    tile, kernel 5 on its fused launch."""
    _need_cuda()
    from repro_torch.core.routers.artifacts import load_router, save_router
    from repro_torch.core.routers.dispatch import DispatchPolicy
    from repro_torch.kernels.knn_ivf import autotune as at
    lam = np.full(16, 0.5, np.float32)
    for spec in ("knn20-ivf", "knn20-ivfpq@m=8"):
        r, Q = _tooling_router(spec)
        base = r.serve_fused(Q, lam)
        t = at.autotune_router(r, Q, repeats=3)
        assert t["block_q"] in ivf_ops.IVF_BLOCK_QS
        assert set(t["sweep"]["block_q"]) == set(ivf_ops.IVF_BLOCK_QS)
        times = {c["p50_s"] for c in t["sweep"]["block_q"].values()}
        assert all(0 < x < 0.1 for x in times)
        if r.index == "ivfpq":
            assert len(times) == 1 and t["probe_chunk"] == 0
        tiles = {k: v for k, v in t.items() if k != "sweep"}
        r.dispatch_policy = DispatchPolicy(cells={}, tiles={r.index: tiles})
        r2 = load_router(save_router(r, tmp_path / spec), device="cuda")
        got = r2.serve_fused(Q, lam)
        if r.index == "ivf":
            assert ivf_ops.ivf_scan.last_block_q == tiles["block_q"]
        else:
            assert ivf_ops.ivfpq_adc.last_cuda_launches == 1
        for a, b in zip(base, got):
            np.testing.assert_array_equal(a, b)
