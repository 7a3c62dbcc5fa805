"""Roofline dry-run of the paper's technique at production scale: the
mesh-sharded exact kNN retrieval (`core.sharded_knn.sharded_knn_topk`),
the counterpart of `repro.launch.knn_dryrun`, with the same CLI and
defaults, over the H100's constants (`launch.mesh`).

    PYTHONPATH=src python -m repro_torch.launch.knn_dryrun \\
        --n 100000000 --q 1024 --k 100 --out results/knn_roofline.json

It needs no card: it runs ``sharded_knn_topk`` once as rank 0 of a fake
process group of the mesh's ranks (default the production mesh, 16 x 16
= 256 ranks; ``--mesh 2x4`` another) under ``FakeTensorMode``, so rank
0's shard of N / ranks rows, its kernel (the plain version on fake
tensors, the same work) and its all-gather are traced, not run.
`launch.cost_analysis.measure` records the FLOPs, the collectives and the
peak memory; the bytes are reckoned as `chip_smoke.bound` reckons them
(the shard and the queries read once, the outputs written once).  The
three terms:

    t_compute    = FLOPs / PEAK_FLOPS[support dtype]
    t_memory     = bytes / HBM_BW
    t_collective = ring-model collective bytes / link_bw(ranks)

(NVLink each way inside one node of 8, 50 GB/s NDR across nodes), and
the dominant one, for each variant: ``f32``, ``bf16``, ``bf16_klocal8``
and ``f32_klocal8`` (the support's dtype; each rank's candidate count
k_local).  The record is written by `persist.atomic_write_text`.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch import persist
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS, fake_mesh, link_bw

VARIANTS = {
    "f32": (torch.float32, 0),
    "bf16": (torch.bfloat16, 0),
    "bf16_klocal8": (torch.bfloat16, 8),
    "f32_klocal8": (torch.float32, 8),
}


def run_variant(mesh, n, q, d, k, dtype, k_local):
    """Trace rank 0's search: (`cost_analysis.StepRecord`, the record's
    bytes reckoning)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.sharded_knn import LocalShard, sharded_knn_topk
    ranks = mesh.size()
    rows_per = -(-n // ranks)
    kk = min(k_local or k, rows_per)
    with FakeTensorMode():
        queries = torch.empty((q, d), dtype=torch.float32)
        shard = LocalShard(torch.empty((rows_per, d), dtype=dtype), n)
        _, rec = CA.measure(sharded_knn_topk, queries, shard, k, mesh,
                            k_local=k_local)
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = rows_per * d * itemsize + q * d * 4 + q * k * 8
    return rec, dict(rows_per_rank=rows_per, kk=kk, bytes=nbytes)


def analyze(rec, shape, label, dtype, ranks):
    coll = CA.collective_bytes(rec.collectives)
    peak = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    flops = CA.cost_summary(rec)["flops"]
    out = {
        "variant": label,
        "flops": flops, "bytes": float(shape["bytes"]),
        "coll_bytes": coll["total"], "coll_by_op": coll,
        "collectives": [r._asdict() for r in rec.collectives],
        "t_compute_s": flops / peak,
        "t_memory_s": shape["bytes"] / HBM_BW,
        "t_collective_s": coll["total"] / link_bw(ranks),
        "memory": CA.memory_summary(rec),
        "peak_flops": peak, "hbm_bw": HBM_BW, "link_bw": link_bw(ranks),
        "rows_per_rank": shape["rows_per_rank"], "kk": shape["kk"],
    }
    out["dominant"] = max(("compute", "memory", "collective"),
                          key=lambda t: out[f"t_{t}_s"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--out", default="results/knn_roofline.json")
    ap.add_argument("--variants", default="f32,bf16,bf16_klocal8")
    ap.add_argument("--mesh", default="16x16",
                    help="mesh shape, data x model (default: the "
                         "production mesh, 256 ranks)")
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.mesh.split("x"))
    mesh = fake_mesh(shape)
    ranks = mesh.size()
    results = []
    for v in args.variants.split(","):
        dtype, k_local = VARIANTS[v]
        print(f"=== knn {v}: N={args.n} Q={args.q} k={args.k} "
              f"k_local={k_local or args.k} ranks={ranks} ===", flush=True)
        rec, sh = run_variant(mesh, args.n, args.q, args.d, args.k, dtype,
                              k_local)
        r = analyze(rec, sh, v, dtype, ranks)
        r.update(n=args.n, q=args.q, d=args.d, k=args.k,
                 k_local=k_local or args.k, mesh=list(shape), ranks=ranks)
        results.append(r)
        print(f"  compute {r['t_compute_s']:.2e}s  memory "
              f"{r['t_memory_s']:.2e}s  collective "
              f"{r['t_collective_s']:.2e}s  -> {r['dominant']}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    persist.atomic_write_text(out, json.dumps(results, indent=1,
                                              default=float))
    print(f"[knn_dryrun] wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
