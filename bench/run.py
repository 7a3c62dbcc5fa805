#!/usr/bin/env python3
"""Run one cell of `BENCHMARK.json` once, on the card it is started on.

    python3 bench/run.py --workload route.knn100-1m.backlog --seed 7 \\
        --seconds 30 --trace 0

Set-up (imports, the card, the kernels' libraries, weights, inputs and the
cell's warm-up) is timed as ``setup_s``; then the window measures for
``--seconds``.  With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from spans, the
port's counters and a profiler trace of the whole window.  After the window
the port's state is freed and what the timed path produced is judged
against the plain reference (`correct`).  The last line of standard output
is one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error and the result's last key.

Exits 2 without a result where no CUDA card (or too few) is visible, and 3
where a module of JAX or of the JAX package was loaded.
"""
import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment():
    """Caches inside the checkout at fixed paths, few host threads, and no
    JAX loaded by a library on its own."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def eprint(*a):
    print(*a, file=sys.stderr, flush=True)


def card_info():
    """name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def run_cell(args, overrides=None, device=None, extra=None):
    """Set up, measure, judge.  Returns (exit code, result dict or None).
    ``overrides`` ({"config": {...}, "traffic": {...}}) and ``device``
    serve the CPU tests and rehearsals only; ``extra(cell, limits)``
    (`bench/calibrate.py`) reads more after the judgement, into the
    result's ``extra``."""
    import torch

    from bench import common
    from bench.profiling import Tracer, breakdown

    man = common.manifest()
    w = common.workload(man, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            eprint("no CUDA card is visible: the benchmark runs on the card")
            return 2, None
        if torch.cuda.device_count() < int(w["chips"]):
            eprint(f"{w['name']} needs {w['chips']} cards, "
                   f"{torch.cuda.device_count()} visible")
            return 2, None
        device = "cuda"
    import repro_torch  # noqa: F401  (the program: a checkout without it fails here)
    cfg = common.config(man, w["config"])
    tp = common.traffic(w["traffic"])
    for key, target in (("config", cfg), ("traffic", tp)):
        target.update((overrides or {}).get(key, {}))
    spec = SimpleNamespace(config_name=w["config"], cfg=cfg,
                           traffic_name=w["traffic"], traffic=tp,
                           seed=int(args.seed), device=device,
                           workload=w["name"])
    drv = common.driver(cfg["driver"])
    cell = drv.Cell(spec)
    cell.setup()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - _T_START
    eprint("setup_s", setup_s, "phases_ms", json.dumps(
        {k: round(sum(v), 1) for k, v in cell.spans.ms.items()}))
    cell.spans.traced = bool(args.trace)
    tracer = Tracer(torch, bool(args.trace))
    gc.collect()
    with tracer.window(warm=cell.warm_once if args.trace else None):
        e2e = cell.run_window(float(args.seconds))
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    e2e["setup_s"] = setup_s
    reported = {m["name"] for m in man["end_to_end"]
                if applies(m, w["name"], set()) and m["name"] in e2e}
    metrics = {}
    if args.trace:
        if tracer.error:
            eprint(f"trace: {tracer.error}")
        ctx = cell.layer_context(tracer.result)
        for m in man["per_layer"]:
            if not applies(m, w["name"], reported):
                continue
            v = common.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in man["end_to_end"]:
            if m["name"] in reported:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    cell.release()
    lim = common.limits(w["name"])
    readings = cell.check(lim)
    checks = {n: {"value": readings[n], "limit": lim.get(n)}
              for n in drv.CHECKS}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    more = extra(cell, lim) if extra else None
    bad = common.forbidden_modules()
    if bad:
        eprint(f"forbidden modules loaded: {bad}")
        return 3, None
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(cell.attempted),
              "failed": int(cell.failed), "metrics": metrics, "device": dev}
    if args.trace and tracer.result:
        dev["busy_s"] = tracer.result["busy_s"]
        dev["window_s"] = tracer.result["window_s"]
        result["breakdown"] = breakdown(tracer.result)
    result["card"] = card_info() if on_card else None
    result["readings"] = {k: v for k, v in readings.items()
                          if k not in checks}
    if more is not None:
        result["extra"] = more
    result["checks"] = checks
    for n, c in checks.items():
        eprint(f"check {n} {c['value']!r} limit {c['limit']!r}")
    return 0, result


def main(argv=None):
    args = parse(argv)
    _environment()
    code, result = run_cell(args)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
