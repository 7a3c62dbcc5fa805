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
  retrieval  each checkout's `knn_topk` and `ivfpq_adc` wrappers at the
             serving shapes (16 queries against 70,000 rows of 768 f32,
             k 10 / 100 / 200 / 1,024 / 2,048; 64 queries against 100,000
             rows, k 10 and 100, f32 and bf16 at k 10; an IVF-PQ index of
             265 lists of 400 rows, m 64, nbits 8, nprobe 8, kk 800 at
             Q 1 / 16 / 64 and kk 2,048 at Q 16), inputs made on the card
             from fixed seeds.  A time is the mean of 20 calls bracketed by
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
    # a discarded warm-up step first: windows that open on the call lose
    # its first kernels
    traced = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.events())) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    n = sum(1 for e in traced[0] if str(e.device_type).endswith("CUDA")
            and not e.name.startswith("ProfilerStep"))
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
                    (64, 100_000, 10, "bfloat16")]:
    g = torch.Generator(device="cuda").manual_seed(Q * 1_000_003 + N + k)
    q = unit(g, Q, 768)
    s = torch.randn(N, 768, device="cuda", generator=g).to(getattr(torch, dt))
    ms, n = timed(lambda: knn_topk(q, s, k))
    out.append(dict(kernel="knn_topk", case=f"Q={Q} N={N} k={k} {dt}",
                    ms=ms, launches=n))
    del s

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
for Q, kk in [(1, 800), (16, 800), (64, 800), (16, 2048)]:
    g = torch.Generator(device="cuda").manual_seed(Q * 7 + kk)
    q = unit(g, Q, D)
    probe = ivf_probe(q, centroids, 8)
    ms, n = timed(lambda: iv.ivfpq_adc(q, probe, *index, kk, m=m, nbits=8))
    out.append(dict(kernel="ivfpq_adc", case=f"Q={Q} P=8 kk={kk} m=64",
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
