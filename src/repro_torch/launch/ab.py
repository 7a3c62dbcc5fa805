"""Two checkouts of this repository on one GPU, in turns: training steps or
the retrieval kernels.

    python -m repro_torch.launch.ab --a ../parent --b . train -- \\
        --arch mamba2-370m --steps 10 --batch 4 --seq 2048
    python -m repro_torch.launch.ab --a ../parent --b . retrieval

Runs the child once per turn, in the order A, B, B, A, each in a fresh
process with ``PYTHONPATH=<checkout>/src`` and the checkout as its working
directory (so each builds and loads its own CUDA kernels), and prints the
card's name and power limit (where `nvidia-smi` exists), then one JSON line
per turn.  Two checkouts are compared only within one call, on one card.
The children:

  train      `repro_torch.launch.train` with the arguments after ``--``:
             the per-step walls, the median step wall after the first step
             and tokens per second at that median.
  retrieval  each checkout's `knn_topk`, `ivf_scan` and `ivfpq_adc`
             wrappers at the serving shapes (16 queries against 70,000 rows
             of 768 f32, k 10 / 100 / 200 / 1,024 / 2,048; 64 queries
             against 100,000 rows, k 10 and 100, f32 and bf16 at k 10; an
             all-equal support of 20,000 rows at k 300, whose candidates
             overflow into the full-key selection; an IVF index of 265 lists
             of 400 rows, 768 f32, nprobe 8, at Q 1 / 16 / 64 with k 100,
             Q 16 with k 2,048 and 2,049, and 16 queries sharing one probe
             set; 24 lists of 48 rows at nprobe = C; 32 short lists (3-6 of
             64 rows valid) at nprobe 2; an IVF-PQ index of 265 lists of 400
             rows, m 64, nbits 8, nprobe 8, kk 800 at Q 1 / 16 / 64, kk
             2,048 and 3,000 at Q 16, and nprobe = C at Q 1), inputs made on
             the card from fixed seeds.  A time is the mean of 20 calls
             bracketed by
             CUDA events, each after a 256 MB write that flushes the L2 and
             a device spin that lets the host queue the call first;
             ``launches`` is the number of CUDA kernels one call runs, read
             with `torch.profiler` after a discarded warm-up call.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

_TRAIN = """
import json, sys
from repro_torch.launch import train
args = sys.argv[1:]
walls = [r["wall_s"] for r in train.main(args)]
arg = lambda name, default: (int(args[args.index(name) + 1]) if name in args
                             else default)
after = sorted(walls[1:]) or walls
median = after[len(after) // 2]
print("RESULT " + json.dumps(dict(
    step_wall_s=walls, median_step_wall_s_after_first=median,
    tokens_per_s=arg("--batch", 8) * arg("--seq", 128) / median)))
"""

_RETRIEVAL = r'''
import json
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule
from repro_torch.kernels.knn_ivf import ops as iv
from repro_torch.kernels.knn_ivf.ref import ivf_probe
from repro_torch.kernels.knn_topk.ops import knn_topk

torch.backends.cuda.matmul.allow_tf32 = False
flush = torch.empty(64 * 2**20, device="cuda")


def timed(fn, iters=20):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(10_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    # as chip_smoke.py's `device_profile` reads it: CPU and CUDA activity,
    # a discarded warm-up step first (windows that open on the call lose its
    # first kernels), the window's key_averages
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    n = sum(e.count for e in traced[0] if str(e.device_type).endswith("CUDA")
            and not e.key.startswith("ProfilerStep"))
    return total / iters, n


def unit(g, Q, D):
    q = torch.randn(Q, D, device="cuda", generator=g)
    return q / q.norm(dim=1, keepdim=True)


out = []
for Q, N, k, dt in [(16, 70_000, 10, "float32"), (16, 70_000, 100, "float32"),
                    (16, 70_000, 200, "float32"),
                    (16, 70_000, 1024, "float32"),
                    (16, 70_000, 2048, "float32"),
                    (64, 100_000, 10, "float32"),
                    (64, 100_000, 100, "float32"),
                    (64, 100_000, 10, "bfloat16"),
                    (4, 20_000, 300, "all equal")]:
    g = torch.Generator(device="cuda").manual_seed(Q * 1_000_003 + N + k)
    q = unit(g, Q, 768)
    s = torch.randn(N, 768, device="cuda", generator=g)
    if dt == "all equal":
        s[:] = s[0]
    else:
        s = s.to(getattr(torch, dt))
    ms, n = timed(lambda: knn_topk(q, s, k))
    out.append(dict(kernel="knn_topk", case=f"Q={Q} N={N} k={k} {dt}",
                    ms=ms, launches=n))
    del s


def ivf_index(g, C, L, D, counts):
    """Unit rows, counts[c] valid in list c (ids -1 / inv 0 past them);
    centroids the lists' normalised means."""
    sup = torch.randn(C, L, D, device="cuda", generator=g)
    sup /= sup.norm(dim=2, keepdim=True)
    valid = torch.arange(L, device="cuda")[None, :] < torch.as_tensor(
        counts, device="cuda")[:, None]
    sup *= valid[..., None]
    ids = torch.where(valid, valid.flatten().cumsum(0).view(C, L) - 1,
                      torch.full_like(valid, -1, dtype=torch.int64))
    cent = sup.sum(1)
    cent /= cent.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return (cent, sup.contiguous(), ids.to(torch.int32).contiguous(),
            valid.to(torch.float32).contiguous())


g = torch.Generator(device="cuda").manual_seed(4)
big = ivf_index(g, 265, 400, 768, [70_000 // 265 + (c < 70_000 % 265)
                                   for c in range(265)])
small = ivf_index(g, 24, 48, 128, [40] * 24)
short = ivf_index(g, 32, 64, 128, [3 + c % 4 for c in range(32)])
for name, idx, Q, P, k, shared in [
        ("main", big, 16, 8, 100, False), ("Q=1", big, 1, 8, 100, False),
        ("Q=64", big, 64, 8, 100, False), ("k=2048", big, 16, 8, 2048, False),
        ("k=2049", big, 16, 8, 2049, False),
        ("shared probes", big, 16, 8, 100, True),
        ("nprobe=C", small, 16, 24, 100, False),
        ("short lists", short, 16, 2, 100, False)]:
    cent, sup, ids, inv = idx
    gq = torch.Generator(device="cuda").manual_seed(Q * 31 + P * 7 + k)
    q = unit(gq, Q, sup.shape[2])
    probe = ivf_probe(q[:1] if shared else q, cent, P).expand(Q, P)
    probe = probe.contiguous()
    ms, n = timed(lambda: iv.ivf_scan(q, probe, sup, ids, inv, k))
    out.append(dict(kernel="ivf_topk", case=f"{name}: Q={Q} P={P} k={k} "
                    f"C={sup.shape[0]} L={sup.shape[1]} D={sup.shape[2]}",
                    ms=ms, launches=n))
del big, small, short

rng = np.random.default_rng(0)
C, L, D, m = 265, 400, 768, 64
counts = np.full(C, 70_000 // C)
counts[:70_000 % C] += 1
ids = np.full((C, L), -1, np.int32)
at = 0
for c, n in enumerate(counts):
    ids[c, :n] = np.arange(at, at + n)
    at += n
inv = np.where(ids >= 0, 1 + rng.random((C, L)), 0).astype(np.float32)
cent = rng.standard_normal((C, D), dtype=np.float32)
cent /= np.linalg.norm(cent, axis=1, keepdims=True)
anchors = 0.05 * rng.standard_normal((C, D), dtype=np.float32)
codes = rng.integers(0, 256, (C, m, L), dtype=np.uint8)
cb = 0.05 * rng.standard_normal((m, 256, D // m), dtype=np.float32)
t = lambda a: torch.from_numpy(a).cuda()
index = [t(codes), t(ids), t(inv), t(anchors), t(cb)]
centroids = t(cent)
for Q, P, kk in [(1, 8, 800), (16, 8, 800), (64, 8, 800), (16, 8, 2048),
                 (16, 8, 3000), (1, C, 800)]:
    g = torch.Generator(device="cuda").manual_seed(Q * 7 + kk)
    q = unit(g, Q, D)
    probe = ivf_probe(q, centroids, P)
    ms, n = timed(lambda: iv.ivfpq_adc(q, probe, *index, kk, m=m, nbits=8))
    out.append(dict(kernel="ivfpq_adc", case=f"Q={Q} P={P} kk={kk} m=64",
                    ms=ms, launches=n))
print("RESULT " + json.dumps({"cases": out}))
'''

CHILDREN = {"train": _TRAIN, "retrieval": _RETRIEVAL}


def run(root: Path, child: str, child_args=()) -> dict:
    """One turn of ``child`` in the checkout at ``root``: its result."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", CHILDREN[child],
                          *child_args], cwd=root, env=env,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"the {child} turn in {root} failed:\n"
                           f"{out.stdout}\n{out.stderr}")
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True, help="first checkout's root")
    ap.add_argument("--b", required=True, help="second checkout's root")
    ap.add_argument("child", choices=sorted(CHILDREN))
    ap.add_argument("child_args", nargs=argparse.REMAINDER,
                    help="the train child's arguments, after --")
    args = ap.parse_args(argv)
    child_args = [a for a in args.child_args if a != "--"]
    roots = {"A": Path(args.a).resolve(), "B": Path(args.b).resolve()}
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    results = []
    for turn in "ABBA":
        r = dict(run=turn, checkout=str(roots[turn]),
                 **run(roots[turn], args.child, child_args))
        print(json.dumps(r), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
