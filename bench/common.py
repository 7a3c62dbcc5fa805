"""Paths, the manifest and the files the harness finds by name.

A cell of `BENCHMARK.json` names a configuration and a traffic mix:

- ``bench/configs/<config>.json``: the configuration's sizes, its
  ``driver`` (a module ``bench/drivers/<driver>.py``) and its plain
  reference ``bench/configs/<config>.ref.py``;
- ``bench/traffic/<traffic>.json``: the mix's parameters, read by the one
  generator in `bench.traffic`;
- ``bench/metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(ctx)`` that returns the value or None when the run gave it
  nothing to read;
- ``bench/limits/<workload>.json``: the limit of each number compared.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names the benchmark must never load: JAX, its
#: libraries and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(workloads: {[w['name'] for w in man['workloads']]})")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def config(man: dict, name: str) -> dict:
    return load_json(ROOT / config_entry(man, name)["file"])


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    path = BENCH / "limits" / f"{workload_name}.json"
    return load_json(path) if path.exists() else {}


def load_file(path: Path, modname: str):
    """Import a file whose name need not be a Python identifier."""
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def reference(config_name: str):
    """The configuration's plain reference, ``configs/<name>.ref.py``."""
    return load_file(BENCH / "configs" / f"{config_name}.ref.py",
                     "bench_ref_" + _ident(config_name))


def driver(name: str):
    return load_file(BENCH / "drivers" / f"{name}.py",
                     "bench_driver_" + _ident(name))


def metric_reader(name: str):
    return load_file(BENCH / "metrics" / f"{name}.py",
                     "bench_metric_" + _ident(name))


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def sub_seed(seed: int, *key) -> int:
    """A seed of its own for one stream of the run (weights, texts,
    arrivals, ...), from the run's ``--seed`` and the stream's name, so one
    stream's draws never shift another's.  Fits a torch generator's 64
    bits and numpy's seeds."""
    h = hashlib.sha256(repr((int(seed),) + key).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden
    (`repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})
