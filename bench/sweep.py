#!/usr/bin/env python3
"""The knee of an open-loop route cell: one set-up, then a window at each
offered rate, with the mix's burst shape:

    python3 bench/sweep.py --workload route.knn100-1m.open --seed 5 \\
        --seconds 20 --rates 1500,2000,2500,3000

One JSON line a rate: the 50th and 95th percentiles and the largest
latency, how long after the window's end the last request was answered
(``drain_s``), how late the loop submitted a request at most, the mean
routes a wave, and the 95th percentile of each
burst period, first to last.  The knee is the highest rate whose backlog
does not grow over the window: the last periods' tails no higher than the
first's and the drain under one period's share of a burst.  The
benchmark's own runs never run this."""
import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from bench import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--override", default="{}",
                    help="JSON {config: {...}, traffic: {...}}: CPU "
                         "rehearsals at a small size")
    a = ap.parse_args(argv)
    run._environment()
    import numpy as np

    from bench import common
    man = common.manifest()
    w = common.workload(man, a.workload)
    cfg = common.config(man, w["config"])
    tp = common.traffic(w["traffic"])
    ov = json.loads(a.override)
    cfg.update(ov.get("config", {}))
    tp.update(ov.get("traffic", {}))
    cell = common.driver(cfg["driver"]).Cell(SimpleNamespace(
        config_name=w["config"], cfg=cfg, traffic_name=w["traffic"],
        traffic=tp, seed=a.seed, device=a.device, workload=w["name"]))
    cell.setup()
    period = float(tp["burst_period_s"])
    for rate in [float(r) for r in a.rates.split(",")]:
        tp["rate"] = rate
        out = cell.run_window(a.seconds)
        lat = cell.latency_ms
        per = [float(np.percentile(lat[(cell.due >= t) & (cell.due < t +
                                                           period)], 95))
               for t in np.arange(0, a.seconds, period)]
        done = cell.done_at[np.isfinite(cell.done_at)]
        print(json.dumps({
            "rate": rate, "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": out["route_p95_ms"], "max_ms": float(np.max(lat)),
            "drain_s": float(done.max() - a.seconds) if len(done) else None,
            "submit_lag_ms": cell.lag_s * 1e3,
            "failed": cell.failed, "requests": cell.attempted,
            "waves": len(cell.waves),
            "routes_per_wave": cell.attempted / max(len(cell.waves), 1),
            "p95_by_period_ms": per}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
