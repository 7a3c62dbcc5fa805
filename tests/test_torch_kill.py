"""Kill-injection suite of the port (marked ``kill``, as the reference's):
forks ``python -m repro_torch.launch.kill_child`` on the CPU, SIGKILLs it
at the nine instrumented barriers of `repro_torch.persist` (mid-WAL-append,
pre/post fsync, mid-index-append, mid-checkpoint-publish, before a
compaction's swap on the synchronous and the background path), recovers in
a second child, and asserts that (a) nothing acknowledged is lost, (b) no
corrupt artifact is loaded, and (c) where the reference asserts it, the
recovered retrieval fingerprint equals that of an uncrashed port run over
the same applied batches.  These are the ten `KILL_SCENARIOS` of
`tests/test_durability.py` and its crash-recover-crash test.  Every
barrier fires at an exact instruction, and every child has a timeout."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving.encoder import default_encoder  # noqa: E402
from repro_torch.serving.router_service import RouterService  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
NAMES = ["model-a", "model-b"]
CHILD_TIMEOUT_S = 300


def _run_child(root, mode, *, batches=6, recluster="auto", kill_at=None,
               kill_after=1):
    env = dict(os.environ)
    env.pop("REPRO_KILL_AT", None)
    env.pop("REPRO_KILL_AFTER", None)
    env["PYTHONPATH"] = str(SRC)
    if kill_at is not None:
        env["REPRO_KILL_AT"] = kill_at
        env["REPRO_KILL_AFTER"] = str(kill_after)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.kill_child", "--root",
         str(root), "--mode", mode, "--batches", str(batches), "--recluster",
         recluster, "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=CHILD_TIMEOUT_S)


def _parse(out: str) -> dict:
    d = {"acked": len(re.findall(r"^ACK seq=\d+", out, re.M))}
    for pat, key, cast in [
            (r"^RECOVERED applied=(\d+)", "applied", int),
            (r"support=(\d+)\s*$", "support", int),
            (r"^FINGERPRINT (\w+)", "fingerprint", str),
            (r"^PROBE ([\d.]+)", "probe", float),
            (r"skipped=(\d+)", "skipped", int),
            (r"torn=(\d+)", "torn", int)]:
        m = re.search(pat, out, re.M)
        if m:
            d[key] = cast(m.group(1))
    return d


_REFERENCE_CACHE: dict = {}


def _uncrashed_fingerprint(tmp_path_factory, applied: int) -> str:
    """Fingerprint of an uncrashed port run that observed ``applied``
    batches."""
    if applied not in _REFERENCE_CACHE:
        root = tmp_path_factory.mktemp(f"ref{applied}")
        proc = _run_child(root / "state", "fresh", batches=applied)
        assert proc.returncode == 0, proc.stderr
        _REFERENCE_CACHE[applied] = _parse(proc.stdout)["fingerprint"]
    return _REFERENCE_CACHE[applied]


#: (barrier, kill_after, recluster, compare_fingerprint): the reference's
#: table.  A background compaction's crash recovers correctly, but its
#: checkpoint can hold another (base, delta) split than the synchronous
#: history, so bitwise identity is asserted on the synchronous scenarios.
KILL_SCENARIOS = [
    ("wal-mid-record", 2, "auto", True),
    ("wal-pre-fsync", 2, "auto", True),
    ("wal-post-fsync", 3, "auto", True),
    ("index-mid-append", 3, "auto", True),
    ("atomic-pre-rename", 3, "auto", True),     # state.npz of 1st cadence ckpt
    ("atomic-post-rename", 4, "auto", True),    # manifest inside the tmp dir
    ("ckpt-pre-rename", 2, "auto", True),       # complete tmp dir, unpublished
    ("ckpt-post-rename", 2, "auto", True),      # published, prune never ran
    ("recluster-pre-swap", 1, "auto", True),    # sync compaction mid-observe
    ("recluster-pre-swap", 1, "background", False),
]


@pytest.mark.kill
@pytest.mark.parametrize(
    "barrier,after,recluster,compare",
    KILL_SCENARIOS,
    ids=[f"{b}-x{a}-{r}" for b, a, r, _ in KILL_SCENARIOS])
def test_sigkill_then_recover_loses_nothing_acknowledged(
        tmp_path, tmp_path_factory, barrier, after, recluster, compare):
    root = tmp_path / "state"
    crashed = _run_child(root, "fresh", recluster=recluster,
                         kill_at=barrier, kill_after=after)
    assert crashed.returncode == -9, (
        f"barrier {barrier} x{after} did not SIGKILL the child:\n"
        f"{crashed.stdout}\n{crashed.stderr}")
    acked = _parse(crashed.stdout)["acked"]

    rec = _run_child(root, "recover")
    assert rec.returncode == 0, rec.stderr
    got = _parse(rec.stdout)
    assert got["applied"] >= acked, (barrier, crashed.stdout, rec.stdout)
    assert got["skipped"] == 0
    assert got["support"] == 28 + 4 * got["applied"]
    if got["applied"] > 0:
        assert got["probe"] > 1.5, rec.stdout
    if compare:
        ref = _uncrashed_fingerprint(tmp_path_factory, got["applied"])
        assert got["fingerprint"] == ref, (
            f"recovered retrieval diverged from the uncrashed run "
            f"({barrier}):\n{rec.stdout}")


@pytest.mark.kill
def test_recovered_process_keeps_serving_and_recovers_again(tmp_path):
    """Crash -> recover -> observe more -> crash -> recover: the WAL /
    checkpoint cycle survives repeated generations."""
    root = tmp_path / "state"
    first = _run_child(root, "fresh", kill_at="wal-post-fsync", kill_after=4)
    assert first.returncode == -9
    rec1 = _run_child(root, "recover")
    assert rec1.returncode == 0, rec1.stderr
    svc = RouterService.recover(root, {m: None for m in NAMES}, device="cpu",
                                encoder=default_encoder("cpu"))
    before = svc.durability.applied_seq
    dim = int(svc.router._X.shape[1])
    rng = np.random.default_rng(99)
    svc.observe(rng.normal(size=(4, dim)).astype(np.float32),
                rng.uniform(0.2, 1.0, (4, 2)).astype(np.float32))
    assert svc.durability.applied_seq == before + 1
    svc.durability.close()
    rec2 = _run_child(root, "recover")
    assert rec2.returncode == 0, rec2.stderr
    assert _parse(rec2.stdout)["applied"] == before + 2
