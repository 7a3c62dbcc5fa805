"""Training steps of two checkouts of this repository on one GPU, in turns.

    python -m repro_torch.launch.train_ab --a ../parent --b . -- \\
        --arch mamba2-370m --steps 10 --batch 4 --seq 2048

Runs `repro_torch.launch.train` once per turn, in the order A, B, B, A,
each in a fresh process with ``PYTHONPATH=<checkout>/src`` and the
checkout as its working directory (so each builds and loads its own CUDA
kernels), and prints one JSON line per run: the checkout, the per-step
walls, the median step wall after the first step and tokens per second at
that median.  Two checkouts are compared only within one call, on one
card.  Needs ``torch`` and the arguments `train` takes after ``--``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

_CHILD = ("import json, sys\n"
          "from repro_torch.launch import train\n"
          "h = train.main(sys.argv[1:])\n"
          "print('HISTORY ' + json.dumps([r['wall_s'] for r in h]))\n")


def _arg(args, name, default):
    return int(args[args.index(name) + 1]) if name in args else default


def run(root: Path, train_args) -> dict:
    """One training run of the checkout at ``root``; its step walls."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", _CHILD, *train_args],
                         cwd=root, env=env, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"training in {root} failed:\n{out.stdout}\n"
                           f"{out.stderr}")
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("HISTORY ")][-1]
    walls = json.loads(line[len("HISTORY "):])
    after = sorted(walls[1:]) or walls
    median = after[len(after) // 2]
    tokens = _arg(train_args, "--batch", 8) * _arg(train_args, "--seq", 128)
    return dict(checkout=str(root), step_wall_s=walls,
                median_step_wall_s_after_first=median,
                tokens_per_s=tokens / median)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True, help="first checkout's root")
    ap.add_argument("--b", required=True, help="second checkout's root")
    ap.add_argument("train_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    train_args = [a for a in args.train_args if a != "--"]
    roots = {"A": Path(args.a).resolve(), "B": Path(args.b).resolve()}
    results = []
    for turn in "ABBA":
        r = dict(run=turn, **run(roots[turn], train_args))
        print(json.dumps(r), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
