"""The port's sharded paths over ``torch.distributed`` on the CPU, against
the reference's on its virtual 8-device mesh and against the port's own
unsharded paths.

One gloo world of 2 and one of 4 ranks (`torch_dist_worker.py`, a
``FileStore``, one spawn each for the module) and the reference on its
8 virtual devices (XLA_FLAGS=--xla_force_host_platform_device_count=8 in
a subprocess, as `test_distributed.py` runs it; two processes) start
together; each writes its outputs
to an ``.npz`` that the tests below read.  The inputs are made here with
numpy from a seed (D 32, 4,003 support rows of 8 topics, 32 queries), the
indexes built once here by the port (their bytes equal the reference's
build) and fed to all three.

Tolerances: sharded scores within 1e-5 of the reference's and of the
unsharded kernel's, ids equal outside ties (a tie: two scores within
1e-5); routers: equal choices, utilities within 1e-5; ``qmesh=``
bitwise; MoE expert parallelism within the reference's own 1e-3 of its
``_moe_shard_map`` and within 1e-5 of the port's local path (f32,
capacity factor 8: nothing dropped).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
TOL = 1e-5
K = 10
#: deterministic numpy / BLAS in every process, so a k-means build in one
#: equals the same build in another
ENV1 = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
        "MKL_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}

#: the reference on its 8 virtual devices, in two processes started
#: together (each sharded call compiles its own shard_map): "search" and
#: "routers" (the routers and the MoE layer)
REF_PROG = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch.mesh import make_debug_mesh

inp, part = np.load(sys.argv[1]), sys.argv[3]
mesh = make_debug_mesh(2, 4)
k = int(inp["k"])
out = {}
if part == "search":
    from repro.core.sharded_knn import (sharded_knn_topk, sharded_ivf_topk,
                                        sharded_ivfpq_topk)
    from repro.kernels.knn_ivf.ops import IVFIndex, assemble_ivfpq
    q, S = jnp.asarray(inp["q"]), jnp.asarray(inp["S"])
    def put(name, pair):
        out[name + "_s"], out[name + "_i"] = (np.asarray(a) for a in pair)
    put("exact", sharded_knn_topk(q, S, k, mesh))
    put("exact_local8", sharded_knn_topk(q, S, k, mesh, k_local=8))
    n = int(inp["n_rows"])
    ivf = IVFIndex(jnp.asarray(inp["ivf_centroids"]),
                   jnp.asarray(inp["ivf_sup"]), jnp.asarray(inp["ivf_ids"]),
                   jnp.asarray(inp["ivf_inv"]), n, inp["ivf_sup"],
                   inp["ivf_ids"], inp["ivf_inv"])
    pq = assemble_ivfpq(inp["pq_centroids"], inp["pq_anchors"],
                        inp["pq_codes"], inp["pq_ids"], inp["pq_inv"],
                        inp["pq_codebooks"], inp["S"], n, int(inp["pq_m"]), 8)
    put("ivf", sharded_ivf_topk(q, ivf, k, mesh, nprobe=8))
    put("pq", sharded_ivfpq_topk(q, pq, k, mesh, nprobe=8, rerank=8))
else:
    from repro.core.dataset import RoutingDataset
    from repro.core.routers.knn import KNNRouter
    from repro.configs import get_config, reduced
    from repro.models import moe as moe_mod
    ds = RoutingDataset("d", inp["X"], inp["scores"], inp["costs"],
                        [f"m{i}" for i in range(inp["scores"].shape[1])])
    for index in ("exact", "ivf", "ivfpq"):
        r = KNNRouter(k=k, index=index, mesh=mesh).fit(ds)
        for j, o in enumerate(r.serve_fused(inp["Xq"], inp["lam"])):
            out[f"router_{index}_{j}"] = np.asarray(o)
    cfg = reduced(get_config("llama4-maverick-400b-a17b")).replace(
        dtype="float32", capacity_factor=8.0, moe_shard_map=True)
    params = {n[4:]: jnp.asarray(inp[n]) for n in inp.files
              if n.startswith("moe_") and not n.startswith("moe_shared_")
              and n != "moe_x"}
    params["shared"] = {n[11:]: jnp.asarray(inp[n]) for n in inp.files
                        if n.startswith("moe_shared_")}
    m22 = make_debug_mesh(2, 2)
    with m22:
        y, aux = jax.jit(lambda p, x: moe_mod.moe_ffn(p, cfg, x, mesh=m22))(
            params, jnp.asarray(inp["moe_x"]))
    out["moe_ep"], out["moe_ep_aux"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


def _inputs(path):
    """The seeded inputs of every process, built here (the indexes by the
    port, on the CPU)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.knn_ivf.ops import (build_ivf_index,
                                                 build_ivfpq_index)
    rng = np.random.default_rng(0)
    D, N, T = 32, 4003, 8
    centers = rng.normal(size=(T, D)).astype(np.float32) * 3
    S = (centers[rng.integers(0, T, N)]
         + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, T, 32)]
         + rng.normal(size=(32, D))).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    extra = (centers[rng.integers(0, T, 300)]
             + rng.normal(size=(300, D))).astype(np.float32)
    ivf = build_ivf_index(S, seed=0, device="cpu")
    pq = build_ivfpq_index(S, seed=0, device="cpu")
    X = (centers[rng.integers(0, T, 600)]
         + rng.normal(size=(600, D))).astype(np.float32)
    scores = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    costs = rng.uniform(0, 0.01, (600, 3)).astype(np.float32)
    Xq = (centers[rng.integers(0, T, 16)]
          + rng.normal(size=(16, D))).astype(np.float32)
    lam = np.array([0.0, 0.5, 2.0, 100.0] * 4, np.float32)
    cfg = reduced(get_config("llama4-maverick-400b-a17b"))
    E, Dm, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    w = lambda *s: (rng.normal(size=s) / np.sqrt(s[-2])).astype(  # noqa
        np.float32)
    moe = {"moe_router": w(Dm, E), "moe_w_gate": w(E, Dm, F),
           "moe_w_up": w(E, Dm, F), "moe_w_down": w(E, F, Dm),
           "moe_x": rng.normal(size=(4, 16, Dm)).astype(np.float32)}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * F
        moe.update(moe_shared_w_gate=w(Dm, Fs), moe_shared_w_up=w(Dm, Fs),
                   moe_shared_w_down=w(Fs, Dm))
    np.savez(path, S=S, q=q, k=K, n_rows=N, extra=extra,
             ivf_centroids=ivf.centroids_h, ivf_sup=ivf.sup_h,
             ivf_ids=ivf.ids_h, ivf_inv=ivf.inv_h,
             pq_centroids=pq.centroids_h, pq_anchors=pq.anchors_h,
             pq_codes=pq.codes_h, pq_ids=pq.ids_h, pq_inv=pq.inv_h,
             pq_codebooks=pq.codebooks_h, pq_m=pq.m, X=X, scores=scores,
             costs=costs, Xq=Xq, lam=lam, **moe)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": reference outputs, 2: [rank outputs], 4: [...]}: the four
    processes started together, waited for together."""
    tmp = tmp_path_factory.mktemp("dist")
    inputs = tmp / "inputs.npz"
    _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ENV1)
    procs = {part: subprocess.Popen(
        [sys.executable, "-c", REF_PROG, str(inputs),
         str(tmp / f"ref_{part}.npz"), part], env=dict(
            env, XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part in ("search", "routers")}
    for w in WORLDS:
        (tmp / f"w{w}").mkdir()
        procs[w] = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
             str(w), str(inputs), str(tmp / f"w{w}")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {n: p.communicate(timeout=400)[0] for n, p in procs.items()}
    for n, p in procs.items():
        assert p.returncode == 0, f"{n}:\n{logs[n][-6000:]}"
    out = {"ref": {**np.load(tmp / "ref_search.npz"),
                   **np.load(tmp / "ref_routers.npz")}}
    for w in WORLDS:
        out[w] = [dict(np.load(tmp / f"w{w}" / f"rank{r}.npz"))
                  for r in range(w)]
    return out


def assert_topk(sa, ia, sb, ib, tol=TOL):
    """Scores within ``tol``; ids equal wherever a score has no other
    within ``tol`` in its row (outside ties)."""
    np.testing.assert_allclose(sa, sb, atol=tol, rtol=0)
    for row_s, a, b in zip(sa, ia, ib):
        fin = np.isfinite(row_s)
        gap = np.abs(row_s[:, None] - row_s[None, :])
        np.fill_diagonal(gap, np.inf)
        alone = fin & (gap.min(1) > tol)
        np.testing.assert_array_equal(a[alone], b[alone])
        np.testing.assert_array_equal(a[~fin], -1)
        np.testing.assert_array_equal(b[~fin], -1)


def _pair(d, name):
    return d[name + "_s"], d[name + "_i"]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree_bitwise(runs, world):
    """Every rank holds the same merged outputs (a replicated result; a
    DTensor's local shard excepted)."""
    first = runs[world][0]
    for other in runs[world][1:]:
        for key, v in first.items():
            if key != "constrain_local":
                np.testing.assert_array_equal(other[key], v, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["exact", "exact_local8", "ivf", "pq"])
def test_sharded_search_matches_reference(runs, world, case):
    """The port's sharded search on `world` ranks against the reference's
    `sharded_*` on 8 devices (N 4,003 is a multiple of neither)."""
    assert_topk(*_pair(runs[world][0], case), *_pair(runs["ref"], case))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,plain", [
    ("exact", "exact_plain"), ("exact_local8", "exact_plain"),
    ("ivf", "ivf_plain"), ("ivf_all", "exact_plain"), ("pq", "pq_plain"),
    ("pq_raw", "pq_raw_plain")])
def test_sharded_search_matches_unsharded(runs, world, case, plain):
    """Sharded against the port's unsharded kernels (plain versions here);
    probing every list equals the exact scan."""
    r = runs[world][0]
    assert_topk(*_pair(r, case), *_pair(r, plain))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["dyn_ivf", "dyn_pq"])
@pytest.mark.parametrize("stage", ["delta", "rc"])
def test_streaming_index_sharded_matches_unsharded(runs, world, kind, stage):
    """A `DynamicIVFIndex` with 300 appended rows, then after a recluster
    swapped its base: sharded equals the staged unsharded search (the
    compacted base is laid out anew on the next call)."""
    r = runs[world][0]
    assert_topk(*_pair(r, f"{kind}_{stage}"),
                *_pair(r, f"{kind}_{stage}_plain"))
    assert (r[f"{kind}_{stage}_i"] >= 4003).any() or stage == "rc"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("index", ["exact", "ivf", "ivfpq"])
def test_router_mesh_matches_reference_and_unsharded(runs, world, index):
    r = runs[world][0]
    ref = [runs["ref"][f"router_{index}_{j}"] for j in range(5)]
    mesh = [r[f"router_{index}_mesh_{j}"] for j in range(5)]
    plain = [r[f"router_{index}_plain_{j}"] for j in range(5)]
    for other in (ref, plain):
        np.testing.assert_array_equal(mesh[0], other[0])
        for a, b in zip(mesh[1:], other[1:]):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("index", ["exact", "ivf", "ivfpq"])
@pytest.mark.parametrize("qn", [16, 13])
def test_qmesh_bitwise_equal_to_unsharded(runs, world, index, qn):
    """``serve_fused(qmesh=)`` gives the unsharded route's bits, at a batch
    that divides by the ranks and at one padded to them."""
    r = runs[world][0]
    for j in range(5):
        a = r[f"qmesh_{index}_{qn}_qmesh_{j}"]
        b = r[f"qmesh_{index}_{qn}_one_{j}"]
        assert a.dtype == b.dtype and a.shape == b.shape == (qn,) + \
            b.shape[1:]
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("world", WORLDS)
def test_moe_expert_parallel(runs, world):
    """EP on (world / 2) x 2 ranks from the reference's weights cut by
    `convert.moe_shard`: within 1e-3 of the reference's `_moe_shard_map`
    on its 2 x 2 mesh, within 1e-5 of the port's local path; a full layer
    takes the same path bitwise; aux averaged over the mesh."""
    r = runs[world][0]
    np.testing.assert_allclose(r["moe_ep"], runs["ref"]["moe_ep"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(r["moe_ep"], r["moe_local"], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(r["moe_ep"], r["moe_full_ep"])
    if world == 4:      # the same 2 x 2 layout of the batch as the reference
        np.testing.assert_allclose(r["moe_ep_aux"], runs["ref"]["moe_ep_aux"],
                                   atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_constrain_redistributes_dtensors_only(runs, world):
    r = runs[world][0]
    assert list(r["constrain_placements"]) == [0, 1]     # Shard(0), Shard(1)
    n_data = world // 2
    assert r["constrain_local"].shape == (4 // n_data, 4)
    np.testing.assert_array_equal(r["constrain_plain"], np.ones((4, 8)))
    assert bool(r["constrain_outside"])


class _Names:
    """A mesh as `spec_for` reads it: the axis names only."""

    def __init__(self, names):
        self.axis_names = self.mesh_dim_names = tuple(names)


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model")])
def test_spec_for_matches_reference(names):
    from repro.distributed.sharding import DEFAULT_RULES as REF_RULES
    from repro.distributed.sharding import spec_for as ref_spec_for
    from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                                  placements_for, spec_for)
    assert DEFAULT_RULES == REF_RULES
    mesh = _Names(names)
    logicals = [(a,) for a in DEFAULT_RULES] + [
        ("batch", "seq", "embed"), ("batch", "seq", "heads", None),
        ("fsdp", "batch"), ("expert", "capacity", "embed"),
        ("vocab", "embed"), ("layers", "fsdp", "ffn"), (None, "kv_heads"),
        ("heads", "kv_heads", "ffn")]
    for logical in logicals:
        assert spec_for(mesh, logical) == tuple(ref_spec_for(mesh, logical))
        pl = placements_for(mesh, logical)
        assert len(pl) == len(names)


def test_collective_bytes_matches_reference():
    """The ring model on records equals the reference's on the equivalent
    HLO lines, every kind, groups of 1 to 8."""
    from repro.launch.hlo_analysis import collective_bytes as ref_bytes
    from repro_torch.launch.cost_analysis import (CollectiveRecord,
                                                  collective_bytes)
    lines, recs = [], []
    ops = {"all-gather": "all-gather", "reduce-scatter": "reduce-scatter",
           "all-reduce": "all-reduce", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}
    for i, (kind, op) in enumerate(ops.items()):
        for g, shape in ((8, (16, 20)), (4, (3, 5, 7)), (2, (1024,)),
                         (1, (4, 4))):
            n = int(np.prod(shape))
            groups = "{" + ",".join(str(j) for j in range(g)) + "}"
            lines.append(f"  %x{i}{g} = f32[{','.join(map(str, shape))}] "
                         f"{op}(f32[9] %y), replica_groups={{{groups}}}")
            recs.append(CollectiveRecord(kind, 4 * n, g))
    ref = ref_bytes("\n".join(lines))
    got = collective_bytes(recs)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-12), key


def test_knn_dryrun_on_a_fake_group_of_8(tmp_path):
    """`launch.knn_dryrun` at world 8 (a 2 x 4 fake mesh): FLOPs 2 Q (N / W)
    D, one all-gather of the (Q, k_local) scores and ids from each of the 8
    ranks with the ring model's bytes, and the three terms over the H100's
    constants."""
    out = tmp_path / "kr.json"
    N, Q, D, k = 4000, 16, 32, 10
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.knn_dryrun", "--mesh",
         "2x4", "--n", str(N), "--q", str(Q), "--d", str(D), "--k", str(k),
         "--variants", "f32,bf16_klocal8", "--out", str(out)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS
    recs = {r["variant"]: r for r in json.loads(out.read_text())}
    W = 8
    for v, kl, dt, isz in (("f32", k, "float32", 4),
                           ("bf16_klocal8", 8, "bfloat16", 2)):
        r = recs[v]
        assert r["ranks"] == W and r["rows_per_rank"] == N // W
        assert r["flops"] == 2 * Q * (N // W) * D
        result = W * Q * 2 * kl * 4          # (W, Q, 2 kk) f32 words
        assert r["collectives"] == [{"kind": "all-gather",
                                     "result_bytes": result,
                                     "group_size": W}]
        assert r["coll_bytes"] == pytest.approx(result * (W - 1) / W)
        assert r["bytes"] == (N // W) * D * isz + Q * D * 4 + Q * k * 8
        assert r["t_compute_s"] == pytest.approx(r["flops"] / PEAK_FLOPS[dt])
        assert r["t_memory_s"] == pytest.approx(r["bytes"] / HBM_BW)
        assert r["t_collective_s"] == pytest.approx(r["coll_bytes"]
                                                    / NVLINK_BW)
        assert r["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("pq", [False, True])
def test_probe_of_the_dummy_list_yields_nothing(pq):
    """Kernels 4 and 5 (plain versions here; the card's in
    `test_torch_gpu.py`) over a rank's lists with every probe on the empty
    dummy list (ids -1, inverse norms 0): only -inf / -1 slots."""
    from repro_torch.kernels.knn_ivf import ops
    g = torch.Generator().manual_seed(0)
    Q, L, D, P = 5, 8, 16, 3
    q = torch.nn.functional.normalize(torch.randn(Q, D, generator=g), dim=1)
    probe = torch.full((Q, P), 2, dtype=torch.int32)      # list 2: dummy
    ids = torch.arange(3 * L, dtype=torch.int32).reshape(3, L)
    ids[2] = -1
    inv = torch.ones(3, L)
    inv[2] = 0
    if pq:
        codes = torch.randint(0, 256, (3, 4, L), dtype=torch.uint8,
                              generator=g)
        s, i = ops.ivfpq_adc(q, probe, codes, ids, inv, torch.randn(3, D),
                             torch.randn(4, 256, D // 4), 4, m=4, nbits=8)
    else:
        s, i = ops.ivf_scan(q, probe, torch.randn(3, L, D), ids, inv, 4)
    assert torch.isinf(s).all() and (s < 0).all()
    assert (i == -1).all()
