#!/usr/bin/env python3
"""Readings that set the limits of a cell's comparison, many seeds in one
process (the kernels are built once):

    python3 bench/calibrate.py --workload route.knn100-1m.backlog \\
        --seeds 11,12,13 --seconds 5 --control 1 --out chiprun_out/cal.jsonl

For each seed: a run of the cell as `bench/run.py` makes it (a window of
``--seconds``) and the program's readings; with ``--control 1`` also the
control's (the reference put in the program's place in the precision
below the configuration's) and, for a training cell, the fault of half of
each batch left out.  One JSON line a seed, to standard output and to
``--out``.  The benchmark's own runs never run this."""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from bench import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    run._environment()

    def extra(cell, lim):
        if not a.control:
            return None
        out = {"control": cell.control(lim)}
        if hasattr(cell, "fault_half_batch"):
            out["half_batch"] = cell.fault_half_batch(lim)
        return out

    code = 0
    for seed in [int(s) for s in a.seeds.split(",")]:
        t = time.perf_counter()
        args = run.parse(["--workload", a.workload, "--seed", str(seed),
                          "--seconds", str(a.seconds), "--trace",
                          str(a.trace)])
        rc, res = run.run_cell(args, extra=extra)
        line = json.dumps({"seed": seed, "rc": rc, "wall_s":
                           time.perf_counter() - t, "result": res})
        print(line, flush=True)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            with open(a.out, "a") as f:
                f.write(line + "\n")
        code = code or rc
    return code


if __name__ == "__main__":
    sys.exit(main())
