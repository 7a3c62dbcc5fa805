"""Nothing the benchmark loads is JAX or the JAX package: a fresh process
imports the harness, every driver, reference and metric reader, and the
port's modules the drivers call."""
import json
import subprocess
import sys

from bench.tests.conftest import ROOT

PROBE = r"""
import json, sys
sys.path[:0] = [%r, %r]
from bench import common, run, calibrate, sweep, profiling, roofline, traffic, plain
man = common.manifest()
for w in man["workloads"]:
    cfg = common.config(man, w["config"])
    common.reference(w["config"])
    common.driver(cfg["driver"])
for m in man["per_layer"]:
    common.metric_reader(m["name"])
import repro_torch.serving.router_service, repro_torch.serving.scheduler
import repro_torch.training.train_step, repro_torch.models.model
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_or_jax_package_loaded():
    out = subprocess.run([sys.executable, "-c",
                          PROBE % (str(ROOT / "src"), str(ROOT))],
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "bench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top


def test_forbidden_names_compare_whole(monkeypatch):
    import types

    from bench import common
    before = set(common.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("repro_torch_like"))
    assert set(common.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.sub", types.ModuleType("sub"))
    assert "repro" in common.forbidden_modules()
