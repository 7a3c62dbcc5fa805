"""The port's lint engine (`repro_torch.analysis`): each rule catches a
seeded violation in PyTorch idiom with a file:line report, pragmas and
baselines suppress with a justification, the CLI fails and passes, and the
shipped `src/repro_torch` tree is clean with ZERO baselined findings (the
port of `tests/test_lint.py`; trees are written under ``tmp_path``, the
rules' scope is ``repro_torch/``)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis.core import Pragmas, write_baseline
from repro_torch.analysis.lint import build_project, lint_paths

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
PORT = SRC / "repro_torch"


def put(root: Path, rel: str, code: str) -> Path:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    return path


def lint(root, **kw):
    return lint_paths(Path(root), **kw)


# ---------------------------------------------------------------------------
# the shipped tree
# ---------------------------------------------------------------------------

def test_port_tree_clean_with_empty_baseline():
    """The acceptance bar: zero findings over src/repro_torch and zero
    baselined — every intentional host/lock/graph exception is a justified
    pragma, and the shipped baseline holds no key."""
    base = PORT / "analysis" / "lint_baseline.txt"
    active, suppressed = lint(
        PORT, config={"baseline": str(base)})
    assert [f.render() for f in active] == []
    assert suppressed == []
    from repro_torch.analysis.core import load_baseline
    assert load_baseline(base) == set()


def test_package_root_is_named_with_its_package():
    """Linting src/repro_torch or src gives repro_torch/... paths, so the
    rules' scope and the pragma index see the same names either way."""
    project = build_project(PORT)
    assert all(m.relpath.startswith("repro_torch/") for m in project.modules)
    assert any(m.relpath == "repro_torch/core/routers/knn.py"
               for m in project.modules)


def test_kept_host_syncs_are_real_findings(tmp_path):
    """The port's pragma'd sites are real: the same knn.py with its
    allow-host pragmas stripped reports the end-of-batch copy of
    `serve_fused` (`.cpu()` / `.numpy()`) and the request metadata's
    `np.asarray` as R1."""
    src = (PORT / "core/routers/knn.py").read_text()
    lines = [ln.split("# repro: allow-host")[0].rstrip()
             for ln in src.splitlines()]
    stripped = "\n".join(ln for ln in lines if ln.strip())
    put(tmp_path, "repro_torch/core/routers/knn.py", stripped)
    active, _ = lint(tmp_path, rules=["R1"])
    msgs = [f.message for f in active]
    assert any("`.cpu()`" in m and "serve_fused" in m for m in msgs), msgs
    assert any("`np.asarray`" in m for m in msgs), msgs


# ---------------------------------------------------------------------------
# R1 host sync
# ---------------------------------------------------------------------------

def test_r1_flags_host_sync_in_root(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        import torch

        def serve_fused(emb):
            return emb.cpu()
    """)
    active, _ = lint(tmp_path, rules=["R1"])
    assert len(active) == 1
    f = active[0]
    assert f.rule == "R1" and f.path == "repro_torch/mod.py" and f.line == 5
    assert ".cpu()" in f.message


@pytest.mark.parametrize("expr,what", [
    ("x.item()", ".item()"), ("x.cpu()", ".cpu()"),
    ("x.tolist()", ".tolist()"), ("x.numpy()", ".numpy()"),
    ("x.detach().cpu().numpy()", ".numpy()"),
    ("torch.cuda.current_stream().synchronize()", ".synchronize()"),
    ("torch.cuda.synchronize(x.device)", "torch.cuda.synchronize"),
    ("np.asarray(x)", "np.asarray"), ("np.array(x)", "np.array"),
    ("np.ascontiguousarray(x)", "np.ascontiguousarray"),
    ("float(x.sum())", "float(...)"), ("int(x[0])", "int(...)"),
    ("bool(x.any())", "bool(...)")])
def test_r1_flags_each_torch_sync(tmp_path, expr, what):
    put(tmp_path, "repro_torch/mod.py", f"""
        import numpy as np
        import torch

        def route_fused(x):
            return {expr}
    """)
    active, _ = lint(tmp_path, rules=["R1"])
    assert [f.line for f in active] and {f.line for f in active} == {6}
    assert any(f"`{what}`" in f.message for f in active), active


def test_r1_leaves_device_work_and_bare_coercions_alone(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        import torch

        def serve_fused(x, n):
            y = torch.topk(x, int(n), dim=1)      # int(name): ambiguous
            z = x.to("cpu")                       # left unflagged
            return y, z, float(n)
    """)
    active, _ = lint(tmp_path, rules=["R1"])
    assert active == []


def test_r1_walks_the_call_graph(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        def _helper(x):
            return x.item()

        def serve_fused(x):
            return _helper(x)

        def unrelated(x):
            return x.cpu()            # NOT reachable from a serving root
    """)
    active, _ = lint(tmp_path, rules=["R1"])
    assert [(f.line, f.rule) for f in active] == [(3, "R1")]
    assert ".item()" in active[0].message


def test_r1_scope_is_the_port(tmp_path):
    """Roots and sites outside repro_torch/ are the reference gate's."""
    code = """
        def serve_fused(x):
            return x.cpu()
    """
    put(tmp_path, "repro/mod.py", code)
    put(tmp_path, "repro_torch/mod.py", code)
    active, _ = lint(tmp_path, rules=["R1"])
    assert [f.path for f in active] == ["repro_torch/mod.py"]


def test_r1_pragma_needs_justification(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        import numpy as np

        def route_fused(emb):
            ok = emb.cpu()      # repro: allow-host: input coercion
            bad = emb.cpu()     # repro: allow-host
            return ok, bad
    """)
    active, _ = lint(tmp_path, rules=["R1"])
    # the justified pragma suppresses; the bare one suppresses NOTHING and
    # is itself reported
    assert sorted((f.rule, f.line) for f in active) == [
        ("PRAGMA", 6), ("R1", 6)]


def test_r1_standalone_pragma_covers_next_line(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        def _fused_dispatch(x):
            # repro: allow-host: end-of-batch materialization
            return x.cpu().numpy()
    """)
    active, _ = lint(tmp_path, rules=["R1"])
    assert active == []


def test_pragma_index_matches_the_reference_syntax():
    """One justified pragma satisfies both packages' gates: the port's
    index reads the reference's syntax and rule-to-pragma map."""
    from repro.analysis.core import RULE_PRAGMA as REF_MAP
    from repro.analysis.core import Pragmas as RefPragmas
    from repro_torch.analysis.core import RULE_PRAGMA
    assert RULE_PRAGMA == REF_MAP
    src = ("x = 1  # repro: allow-host: why\n"
           "# repro: allow-unlocked: snapshot\n"
           "y = 2\n"
           "z = 3  # repro: allow-swallow\n")
    a, b = Pragmas(src), RefPragmas(src)
    assert a.lines == b.lines and a.bare == b.bare == [4]
    assert a.covers("allow-unlocked", 3) and not a.covers("allow-host", 2)


# ---------------------------------------------------------------------------
# R2 lock discipline
# ---------------------------------------------------------------------------

def test_r2_flags_unlocked_field_access(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        import threading

        class DynamicIVFIndex:
            def __init__(self):
                self._lock = threading.RLock()
                self._snap = None          # exempt: not yet shared

            def good(self):
                with self._lock:
                    return self._snap

            def bad(self):
                return self._snap
    """)
    active, _ = lint(tmp_path, rules=["R2"])
    assert [(f.line, f.rule) for f in active] == [(14, "R2")]
    assert "_snap" in active[0].message


@pytest.mark.parametrize("field", ["base", "delta_x", "delta_assign",
                                   "appends", "reclusters", "_buf", "_snap"])
def test_r2_guards_each_port_field(tmp_path, field):
    put(tmp_path, "repro_torch/mod.py", f"""
        class DynamicIVFIndex:
            def peek(self):
                return self.{field}
    """)
    active, _ = lint(tmp_path, rules=["R2"])
    assert [f.line for f in active] == [4] and field in active[0].message


def test_r2_lock_does_not_leak_into_closures(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        class DynamicIVFIndex:
            def spawn(self):
                with self._lock:
                    def job():
                        return self.delta_x    # runs on another thread
                    return job
    """)
    active, _ = lint(tmp_path, rules=["R2"])
    assert len(active) == 1 and active[0].line == 6


def test_r2_external_access_needs_receiver_lock(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        from ops import DynamicIVFIndex

        def good(index):
            if isinstance(index, DynamicIVFIndex):
                with index._lock:
                    return index.base
            return index

        def bad(index):
            if isinstance(index, DynamicIVFIndex):
                return index.base
            return index

        def bad_distinctive(obj):
            return obj._snap               # distinctive field, any receiver
    """)
    active, _ = lint(tmp_path, rules=["R2"])
    assert sorted(f.line for f in active) == [12, 16]


def test_r2_pragma_clears_a_snapshot_read(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        def search(index):
            snap = index.fused_state()
            # repro: allow-unlocked: immutable snapshot taken under the lock
            return snap._buf
    """)
    active, suppressed = lint(tmp_path, rules=["R2"])
    assert active == [] and suppressed == []


# ---------------------------------------------------------------------------
# R3 schema pin
# ---------------------------------------------------------------------------

ARTIFACTS = """
    FORMAT_VERSION = {ver}

    class FooRouter:
        state_attrs = ({attrs})

    def save_router(router, path):
        manifest = {{"format_version": FORMAT_VERSION, "family": "foo"}}
        return manifest
"""


def _pin(tmp_path, ver, attrs):
    pin = tmp_path / "pin.json"
    pin.write_text(json.dumps({
        "format_version": ver,
        "state_attrs": {"FooRouter": attrs},
        "manifest_fields": ["family", "format_version"]}))
    return pin


def test_r3_clean_when_schema_matches_pin(tmp_path):
    put(tmp_path, "repro_torch/core/routers/artifacts.py",
        ARTIFACTS.format(ver=3, attrs='"_X", "_sel_lam"'))
    pin = _pin(tmp_path, 3, ["_X", "_sel_lam"])
    active, _ = lint(tmp_path, rules=["R3"],
                     config={"schema_pin": str(pin)})
    assert active == []


def test_r3_flags_state_attrs_drift_without_bump(tmp_path):
    put(tmp_path, "repro_torch/core/routers/artifacts.py",
        ARTIFACTS.format(ver=3, attrs='"_X", "_sel_lam", "_NEW"'))
    pin = _pin(tmp_path, 3, ["_X", "_sel_lam"])
    active, _ = lint(tmp_path, rules=["R3"],
                     config={"schema_pin": str(pin)})
    assert len(active) == 1
    assert "bump FORMAT_VERSION" in active[0].message
    assert "FooRouter" in active[0].message


def test_r3_flags_stale_pin_after_bump(tmp_path):
    """Bumping the version does not silence R3 until the pin is refreshed —
    the bump and the new pin must land together."""
    put(tmp_path, "repro_torch/core/routers/artifacts.py",
        ARTIFACTS.format(ver=4, attrs='"_X", "_sel_lam", "_NEW"'))
    pin = _pin(tmp_path, 3, ["_X", "_sel_lam"])
    active, _ = lint(tmp_path, rules=["R3"],
                     config={"schema_pin": str(pin)})
    assert active and all("refresh the pin" in f.message for f in active)


def test_r3_flags_manifest_drift(tmp_path):
    put(tmp_path, "repro_torch/core/routers/artifacts.py",
        ARTIFACTS.format(ver=3, attrs='"_X", "_sel_lam"').replace(
            '"family": "foo"', '"family": "foo", "extra": 1'))
    pin = _pin(tmp_path, 3, ["_X", "_sel_lam"])
    active, _ = lint(tmp_path, rules=["R3"],
                     config={"schema_pin": str(pin)})
    assert len(active) == 1 and "manifest fields" in active[0].message


SHARED_BASE = """
    def register(name):
        return lambda cls: cls

    class Router:
        state_attrs = ()

    class Base(Router):
        state_attrs = ("_X", "_sel_lam")

    @register("a")
    class ARouter(Base):
        pass

    @register("b")
    class BRouter(Base):
        pass

    class CRouter(BRouter):
        pass

    @register("fam")
    class FamRouter(Router):
        state_attrs = ("_W",)

    @register("fam2")
    class Fam2Router(FamRouter):
        pass
"""


@pytest.mark.parametrize("attrs, drifted", [
    (["_X", "_sel_lam"], []),
    (["_X"], ["ARouter", "BRouter"])])
def test_r3_pins_a_shared_base_under_its_families(tmp_path, attrs, drifted):
    """An unregistered base whose direct subclasses all inherit its
    ``state_attrs`` is pinned under their names (its own name and a
    grandchild's are not pinned); a registered family is pinned under its
    own name though a subclass inherits from it."""
    put(tmp_path, "repro_torch/core/routers/artifacts.py",
        ARTIFACTS.format(ver=3, attrs='"_X", "_sel_lam"').replace(
            "class FooRouter:\n        state_attrs = (\"_X\", "
            "\"_sel_lam\")\n", ""))
    put(tmp_path, "repro_torch/core/routers/families.py", SHARED_BASE)
    pin = tmp_path / "pin.json"
    pin.write_text(json.dumps({
        "format_version": 3,
        "state_attrs": {"ARouter": attrs, "BRouter": attrs,
                        "FamRouter": ["_W"], "Router": []},
        "manifest_fields": ["family", "format_version"]}))
    active, _ = lint(tmp_path, rules=["R3"],
                     config={"schema_pin": str(pin)})
    assert sorted(f.message.split("`")[1].split(".")[0]
                  for f in active) == drifted


def test_r3_ignores_the_reference_routers(tmp_path):
    """A reference tree under the same root is the reference gate's."""
    put(tmp_path, "repro/core/routers/artifacts.py",
        ARTIFACTS.format(ver=9, attrs='"_Z"'))
    active, _ = lint(tmp_path, rules=["R3"],
                     config={"schema_pin": str(tmp_path / "none.json")})
    assert active == []


def test_r3_shipped_pin_matches_source():
    """The checked-in schema_pin.json equals what the port declares."""
    from repro_torch.analysis.rules.schema_pin import (current_schema,
                                                       default_pin_path)
    assert current_schema(build_project(PORT)) == json.loads(
        default_pin_path().read_text())


def test_r3_port_pin_equals_the_reference_pin():
    """Both packages write format v6 with one schema: the two pins, read as
    JSON, are equal (artifacts cross both ways)."""
    port = json.loads((PORT / "analysis/schema_pin.json").read_text())
    ref = json.loads((SRC / "repro/analysis/schema_pin.json").read_text())
    assert port == ref and port["format_version"] == 6


def test_r3_artifacts_cross_both_ways_at_v6(tmp_path):
    import numpy as np
    from repro.core.dataset import RoutingDataset as JD
    from repro.core.routers import KNNRouter as JK
    from repro.core.routers import load_router as jax_load
    from repro.core.routers import save_router as jax_save
    from repro_torch.core.dataset import RoutingDataset as TD
    from repro_torch.core.routers.artifacts import load_router, save_router
    from repro_torch.core.routers.knn import KNNRouter
    rng = np.random.default_rng(0)
    X = rng.normal(size=(120, 8)).astype(np.float32)
    S = rng.uniform(size=(120, 2)).astype(np.float32)
    C = rng.uniform(0, 0.01, (120, 2)).astype(np.float32)
    t = KNNRouter(k=5, device="cpu").fit(TD("d", X, S, C, ["a", "b"]))
    save_router(t, tmp_path / "t")
    j = JK(k=5).fit(JD("d", X, S, C, ["a", "b"]))
    jax_save(j, tmp_path / "j")
    for d in ("t", "j"):
        m = json.loads((tmp_path / d / "manifest.json").read_text())
        assert m["format_version"] == 6
    q = X[:4]
    np.testing.assert_allclose(
        jax_load(tmp_path / "t").predict_utility(q)[0],
        load_router(tmp_path / "j", device="cpu").predict_utility(q)[0],
        atol=1e-5)


# ---------------------------------------------------------------------------
# R4 CUDA-graph / compile-cache hygiene
# ---------------------------------------------------------------------------

def test_r4_flags_unguarded_capture_in_a_method(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        import torch

        class Step:
            def __init__(self):
                self.graph = torch.cuda.CUDAGraph()   # once per object

            def __call__(self, x):
                g = torch.cuda.CUDAGraph()            # fresh every call
                with torch.cuda.graph(g):
                    y = x * 2
                g.replay()
                return y
    """)
    active, _ = lint(tmp_path, rules=["R4"])
    msgs = {f.line: f.message for f in active}
    assert set(msgs) == {9, 10}
    assert all("fresh capture on every call" in m for m in msgs.values())


def test_r4_guarded_capture_passes(tmp_path):
    """`_GraphedStep`'s shape: captured once behind ``is None``, its body
    reading state only __init__ binds."""
    put(tmp_path, "repro_torch/mod.py", """
        import torch

        class Step:
            def __init__(self, step, idx):
                self.step, self.idx = step, idx
                self.graph, self.out = None, None

            def __call__(self, rows):
                if self.graph is None:
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph):
                        self.out = self.step(self.idx)
                self.idx.copy_(rows)
                self.graph.replay()
                return self.out
    """)
    active, _ = lint(tmp_path, rules=["R4"])
    assert [f.render() for f in active] == []


def test_r4_flags_captured_read_of_rebound_state(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        import torch

        class Step:
            def __init__(self, w):
                self.w, self.graph = w, None

            def set_weights(self, w):
                self.w = w                 # a replay never sees this

            def __call__(self, x):
                if self.graph is None:
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph):
                        self.out = x @ self.w
                self.graph.replay()
                return self.out
    """)
    active, _ = lint(tmp_path, rules=["R4"])
    assert [f.line for f in active] == [15]
    assert "self.w" in active[0].message


def test_r4_flags_compile_inside_a_function(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        import torch

        fast = torch.compile(lambda x: x + 1)    # module level: once

        def serve(x):
            f = torch.compile(lambda y: y * 2)   # a fresh cache per call
            return f(x)

        def train(loss_fn):
            @torch.compile
            def step(p):
                return loss_fn(p)
            return step
    """)
    active, _ = lint(tmp_path, rules=["R4"])
    msgs = {f.line: f.message for f in active}
    assert set(msgs) == {7, 12}
    assert "rebuilt on every call" in msgs[7]
    assert "fresh compile cache" in msgs[12]


def test_r4_pragma_and_scope(tmp_path):
    code = """
        import torch

        def capture_once_per_run(x):
            {pragma}
            g = torch.cuda.CUDAGraph()
            return g
    """
    put(tmp_path, "repro/mod.py", code.format(pragma="pass"))
    put(tmp_path, "repro_torch/mod.py", code.format(pragma="pass"))
    active, _ = lint(tmp_path, rules=["R4"])
    assert [f.path for f in active] == ["repro_torch/mod.py"]
    put(tmp_path, "repro_torch/mod.py", code.format(
        pragma="# repro: allow-jit-cache: a benchmark's one capture"))
    active, suppressed = lint(tmp_path, rules=["R4"])
    assert active == [] and suppressed == []


# ---------------------------------------------------------------------------
# R5 silent except in the serving tree
# ---------------------------------------------------------------------------

def test_r5_flags_bare_and_silent_except(tmp_path):
    put(tmp_path, "repro_torch/serving/mod.py", """
        def drain(engine):
            try:
                engine.step()
            except:
                pass
            return engine


        def poll(engine):
            try:
                engine.step()
            except ValueError:
                x = None
            return x
    """)
    active, _ = lint(tmp_path, rules=["R5"])
    assert len(active) == 2
    bare, silent = sorted(active, key=lambda f: f.line)
    assert bare.line == 5 and "bare `except:`" in bare.message
    assert silent.line == 13
    assert "swallows the exception silently" in silent.message
    assert "allow-swallow" in silent.message


def test_r5_handlers_that_record_or_reraise_pass(tmp_path):
    put(tmp_path, "repro_torch/serving/mod.py", """
        def wave(engine, health, box):
            try:
                engine.step()
            except RuntimeError as exc:
                health.record_failure(exc)
            try:
                engine.step()
            except BaseException as exc:
                box["exc"] = exc
            try:
                engine.step()
            except ValueError:
                raise
    """)
    active, _ = lint(tmp_path, rules=["R5"])
    assert [f.render() for f in active] == []


def test_r5_scope_and_pragma(tmp_path):
    code = """
        def poll(engine):
            try:
                engine.step()
            except ValueError:  {pragma}
                x = None
            return x
    """
    put(tmp_path, "repro_torch/core/mod.py", code.format(pragma=""))
    put(tmp_path, "repro_torch/serving/mod.py", code.format(pragma=""))
    put(tmp_path, "repro/serving/mod.py", code.format(pragma=""))
    active, _ = lint(tmp_path, rules=["R5"])
    # same handler in three trees: only the port's serving copy is in scope
    assert [f.path for f in active] == ["repro_torch/serving/mod.py"]
    put(tmp_path, "repro_torch/serving/mod.py", code.format(
        pragma="# repro: allow-swallow: probe failure is the signal"))
    active, suppressed = lint(tmp_path, rules=["R5"])
    assert active == [] and suppressed == []  # justified pragma clears it


# ---------------------------------------------------------------------------
# R6 durable-write discipline
# ---------------------------------------------------------------------------

def test_r6_flags_plain_writes_to_final_paths(tmp_path):
    put(tmp_path, "repro_torch/core/mod.py", """
        import json
        import numpy as np
        import torch

        def save_all(path, arr, meta, fh):
            np.savez(path, arr=arr)
            with open(path, "w") as f:
                f.write("x")
            path.write_text("y")
            json.dump(meta, fh)
            torch.save({"w": arr}, path)
            torch.save(obj={"w": arr}, f=path / "b.pt")
    """)
    active, _ = lint(tmp_path, rules=["R6"])
    msgs = {f.line: f.message for f in active}
    assert set(msgs) == {7, 8, 10, 11, 12, 13}
    assert "atomic_savez" in msgs[7]
    assert "torn file" in msgs[8]
    assert "atomic_write_text" in msgs[10]
    assert "atomic_write_json" in msgs[11]
    assert "torch.save" in msgs[12] and "atomic_write_bytes" in msgs[13]


def test_r6_reads_and_buffer_writes_pass(tmp_path):
    put(tmp_path, "repro_torch/core/mod.py", """
        import io
        import numpy as np
        import torch

        def load_and_serialize(path):
            with open(path) as f:                  # default "r"
                text = f.read()
            with open(path, "rb") as f:
                raw = f.read()
            bio = io.BytesIO()
            np.savez(bio, x=np.zeros(1))           # in-memory: fine
            buf = io.BytesIO()
            torch.save({"x": torch.zeros(1)}, buf)
            torch.save(torch.zeros(1), io.BytesIO())
            return text, raw, bio.getvalue(), buf.getvalue()
    """)
    active, _ = lint(tmp_path, rules=["R6"])
    assert [f.render() for f in active] == []


def test_r6_pragma_and_exempt_helper(tmp_path):
    code = """
        def publish(tmp):
            # repro: allow-plain-write: targets the temp name only
            with open(tmp, "wb") as f:
                f.write(b"x")
            with open(tmp, "ab") as f:
                f.write(b"y")
    """
    put(tmp_path, "repro_torch/mod.py", code)
    active, _ = lint(tmp_path, rules=["R6"])
    # the justified pragma clears line 4; the unpragma'd append still flags
    assert [(f.line, f.rule) for f in active] == [(6, "R6")]
    # the atomic helper module itself is exempt — it IS the plain writer,
    # and the reference's tree is the reference gate's
    put(tmp_path, "repro_torch/persist.py", code.replace(
        "# repro: allow-plain-write: targets the temp name only", "pass"))
    put(tmp_path, "repro/mod.py", code)
    active, _ = lint(tmp_path, rules=["R6"])
    assert [f.path for f in active] == ["repro_torch/mod.py"]


# ---------------------------------------------------------------------------
# baseline mechanics + the CLI
# ---------------------------------------------------------------------------

def test_baseline_suppresses_known_findings(tmp_path):
    put(tmp_path, "repro_torch/mod.py", """
        def route_fused(emb):
            return emb.cpu()
    """)
    base = tmp_path / "baseline.txt"
    active, _ = lint(tmp_path, rules=["R1"])
    assert len(active) == 1
    write_baseline(base, active)
    active2, suppressed2 = lint(tmp_path, rules=["R1"],
                                config={"baseline": str(base)})
    assert active2 == [] and len(suppressed2) == 1


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        capture_output=True, text=True, env=env, cwd=str(REPO))


def test_cli_fails_on_seeded_violation(tmp_path):
    put(tmp_path, "repro_torch/scratch.py", """
        import torch

        def serve_fused(x):
            return x.cpu()
    """)
    proc = _run_cli("--root", str(tmp_path))
    assert proc.returncode == 1
    assert "repro_torch/scratch.py:5: R1:" in proc.stdout


def test_cli_fails_on_seeded_graph_capture(tmp_path):
    put(tmp_path, "repro_torch/scratch.py", """
        import torch

        class Step:
            def run(self):
                g = torch.cuda.CUDAGraph()
                return g
    """)
    proc = _run_cli("--root", str(tmp_path), "--rules", "R4")
    assert proc.returncode == 1
    assert "repro_torch/scratch.py:6: R4:" in proc.stdout


def test_cli_passes_on_clean_tree(tmp_path):
    put(tmp_path, "repro_torch/scratch.py", """
        def serve_fused(x):
            return x
    """)
    proc = _run_cli("--root", str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_baseline_and_schema_pin_round_trip(tmp_path):
    """--write-baseline records the findings so the gate passes on them;
    --update-schema-pin writes the pin R3 then holds the tree to."""
    put(tmp_path, "repro_torch/scratch.py", """
        def serve_fused(x):
            return x.cpu()
    """)
    put(tmp_path, "repro_torch/core/routers/artifacts.py",
        ARTIFACTS.format(ver=2, attrs='"_X",'))
    base, pin = tmp_path / "base.txt", tmp_path / "pin.json"
    args = ("--root", str(tmp_path), "--baseline", str(base),
            "--schema-pin", str(pin))
    assert _run_cli(*args, "--update-schema-pin").returncode == 0
    assert json.loads(pin.read_text())["state_attrs"] == {"FooRouter": ["_X"]}
    assert _run_cli(*args).returncode == 1
    assert _run_cli(*args, "--write-baseline").returncode == 0
    proc = _run_cli(*args)
    assert proc.returncode == 0 and "(1 baselined)" in proc.stdout


def test_cli_over_the_port_tree():
    proc = _run_cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout and "(0 baselined)" in proc.stdout


def test_analysis_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.analysis, repro_torch.analysis.lint\n"
            "import repro_torch.analysis.sanitizers\n"
            "import repro_torch.analysis.rules\n"
            "import repro_torch.kernels.knn_ivf.autotune\n"
            "import repro_torch.launch.mesh\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env)
    assert proc.returncode == 0, proc.stderr
