"""One gloo world of the port's sharded paths on the CPU, for
`test_torch_distributed.py`.

    python tests/torch_dist_worker.py WORLD INPUTS.npz OUT_DIR

spawns WORLD ranks (a ``FileStore`` in OUT_DIR, ``GLOO_SOCKET_IFNAME=lo``)
on a (WORLD / 2, 2) ("data", "model") mesh; every rank runs every case in
the same order (the collectives must line up) and writes its outputs to
OUT_DIR/rank<r>.npz.  The inputs (numpy, seeded by the test) are the
support, the queries, the index arrays the test built, the routing
dataset and the MoE layer's weights.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def _indexes(inp, ops):
    ivf = ops.assemble_ivf(inp["ivf_centroids"], inp["ivf_sup"],
                           inp["ivf_ids"], inp["ivf_inv"],
                           int(inp["n_rows"]), device="cpu")
    pq = ops.assemble_ivfpq(inp["pq_centroids"], inp["pq_anchors"],
                            inp["pq_codes"], inp["pq_ids"], inp["pq_inv"],
                            inp["pq_codebooks"], inp["S"],
                            int(inp["n_rows"]), int(inp["pq_m"]), 8,
                            device="cpu")
    return ivf, pq


def cases(mesh, inp) -> dict:
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import sharded_knn as SK
    from repro_torch.core.dataset import RoutingDataset
    from repro_torch.core.routers import KNNRouter
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.knn_ivf import ops
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.models import convert, moe
    out = {}

    def put(name, pair):
        out[name + "_s"] = pair[0].numpy()
        out[name + "_i"] = pair[1].numpy()

    S = torch.from_numpy(inp["S"])
    q = torch.from_numpy(inp["q"])
    k = int(inp["k"])
    put("exact", SK.sharded_knn_topk(q, S, k, mesh))
    put("exact_local8", SK.sharded_knn_topk(q, S, k, mesh, k_local=8))
    put("exact_plain", knn_topk(q, S, k))
    ivf, pq = _indexes(inp, ops)
    C = ivf.n_clusters
    put("ivf", SK.sharded_ivf_topk(q, ivf, k, mesh, nprobe=8))
    put("ivf_all", SK.sharded_ivf_topk(q, ivf, k, mesh, nprobe=C))
    put("ivf_plain", ops.ivf_topk(q, ivf, k, nprobe=8))
    put("pq", SK.sharded_ivfpq_topk(q, pq, k, mesh, nprobe=8, rerank=8))
    put("pq_raw", SK.sharded_ivfpq_topk(q, pq, k, mesh, nprobe=8,
                                        rerank=0))
    put("pq_plain", ops.ivfpq_topk(q, pq, k, nprobe=8, rerank=8))
    put("pq_raw_plain", ops.ivfpq_topk(q, pq, k, nprobe=8, rerank=0))

    # a streaming index: appended rows, then a compaction swaps the base
    extra = inp["extra"]
    for name, base in (("dyn_ivf", ivf), ("dyn_pq", pq)):
        kw = {"seed": 0} if name == "dyn_ivf" else {"seed": 0,
                                                     "m": pq.m}
        dyn = ops.DynamicIVFIndex(base, delta_cap=10**6, build_kw=kw)
        dyn.append(extra)
        fn = SK.sharded_ivf_topk if name == "dyn_ivf" \
            else SK.sharded_ivfpq_topk
        plain = ops.ivf_topk if name == "dyn_ivf" else ops.ivfpq_topk
        put(name + "_delta", fn(q, dyn, k, mesh, nprobe=8))
        put(name + "_delta_plain", plain(q, dyn, k, nprobe=8,
                                         backend="host"))
        dyn.recluster()
        put(name + "_rc", fn(q, dyn, k, mesh, nprobe=8))
        put(name + "_rc_plain", plain(q, dyn, k, nprobe=8, backend="host"))

    # routers: mesh= against unsharded; qmesh= bitwise
    ds = RoutingDataset("d", inp["X"], inp["scores"], inp["costs"],
                        [f"m{i}" for i in range(inp["scores"].shape[1])])
    Xq, lam = inp["Xq"], inp["lam"]
    for index in ("exact", "ivf", "ivfpq"):
        sharded = KNNRouter(k=k, index=index, mesh=mesh,
                            device="cpu").fit(ds)
        plain = KNNRouter(k=k, index=index, device="cpu").fit(ds)
        for tag, r in (("mesh", sharded), ("plain", plain)):
            for j, o in enumerate(r.serve_fused(Xq, lam)):
                out[f"router_{index}_{tag}_{j}"] = o
        for qn in (16, 13):
            for tag, qm in (("qmesh", mesh), ("one", None)):
                for j, o in enumerate(plain.serve_fused(Xq[:qn], lam[:qn],
                                                        qmesh=qm)):
                    out[f"qmesh_{index}_{qn}_{tag}_{j}"] = o

    # DTensor layouts under the rule table
    from torch.distributed.tensor import Replicate, distribute_tensor
    x = distribute_tensor(torch.arange(32.0).reshape(4, 8), mesh,
                          [Replicate(), Replicate()])
    with SH.sharding_context(mesh):
        y = SH.constrain(x, ("batch", "heads"))
        plain_y = SH.constrain(torch.ones(4, 8), ("batch", "heads"))
    out["constrain_placements"] = np.array(
        [p.dim if p.is_shard() else -1 for p in y.placements])
    out["constrain_local"] = y.to_local().numpy()
    out["constrain_plain"] = plain_y.numpy()
    out["constrain_outside"] = np.array(
        SH.constrain(x, ("batch", "heads")) is x)

    # MoE expert parallelism from the reference's weights
    cfg = reduced(get_config("llama4-maverick-400b-a17b")).replace(
        dtype="float32", capacity_factor=8.0, moe_shard_map=True)
    params = {n[4:]: inp[n] for n in inp.files if n.startswith("moe_")
              and not n.startswith("moe_shared_") and n != "moe_x"}
    params["shared"] = {n[11:]: inp[n] for n in inp.files
                        if n.startswith("moe_shared_")}
    xm = torch.from_numpy(inp["moe_x"])
    mr = mesh.get_coordinate()[list(mesh.mesh_dim_names).index("model")]
    m = mesh.shape[list(mesh.mesh_dim_names).index("model")]
    local = convert.moe_shard(params, cfg, mr, m, device="cpu")
    full = convert.moe_shard(params, cfg, 0, 1, device="cpu")
    y_ep, aux_ep = moe.moe_ffn(local, cfg, xm, mesh=mesh)
    y_full_ep, _ = moe.moe_ffn(full, cfg, xm, mesh=mesh)
    y_loc, aux_loc = moe.moe_ffn(full, cfg.replace(moe_shard_map=False), xm,
                                 mesh=mesh)
    out.update(moe_ep=y_ep.numpy(), moe_ep_aux=aux_ep.numpy(),
               moe_full_ep=y_full_ep.numpy(), moe_local=y_loc.numpy(),
               moe_local_aux=aux_loc.numpy())
    return out


def rank_main(rank, world, inputs, out_dir):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(out_dir) / "store"), world),
        rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh(world // 2, 2, device_type="cpu")
        out = cases(mesh, np.load(inputs))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    world, inputs, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mp.spawn(rank_main, args=(world, inputs, out_dir), nprocs=world)
