"""The port's durable online-index state (`repro_torch.serving.durability`,
`RouterService.observe` / `checkpoint` / `recover`) on the CPU: the WAL,
checkpoint and recovery cases of `tests/test_durability.py`, run on the
port, and the checks across the two packages — a WAL written by either
reads in the other (the same records give the same bytes), a state
directory written by the reference's durable service recovers in the port,
and dynamic artifacts load both ways.  Predictions compare at 1e-5."""
import json
import struct
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dataset import RoutingDataset as JaxDataset  # noqa: E402
from repro.core.routers import load_router as jax_load  # noqa: E402
from repro.core.routers.knn import KNNRouter as JaxKNN  # noqa: E402
from repro.serving import durability as jdur  # noqa: E402
from repro.serving.router_service import RouterService as JaxService  # noqa: E402
from repro_torch import persist  # noqa: E402
from repro_torch.core.dataset import RoutingDataset  # noqa: E402
from repro_torch.core.routers import load_router, save_router  # noqa: E402
from repro_torch.core.routers.artifacts import ArtifactCorruptError  # noqa: E402
from repro_torch.core.routers.knn import KNNRouter  # noqa: E402
from repro_torch.serving.durability import (CheckpointStore,  # noqa: E402
                                            DurabilityManager,
                                            WALCorruptError, WriteAheadLog)
from repro_torch.serving.encoder import default_encoder  # noqa: E402
from repro_torch.serving.faults import FeedbackValidationError  # noqa: E402
from repro_torch.serving.router_service import RouterService  # noqa: E402

NAMES = ["model-a", "model-b"]
TOL = 1e-5


def _batch(n=3, d=6, m=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.uniform(0.2, 1.0, (n, m)).astype(np.float32),
            rng.uniform(0.001, 0.01, (n, m)).astype(np.float32))


def _arrays(n=60, seed=0):
    texts = [f"topic {i % 3} example {i}" for i in range(n)]
    emb = default_encoder("cpu").embed_texts(texts)
    rng = np.random.default_rng(seed)
    return ("mini", emb,
            rng.uniform(0.2, 1.0, (n, len(NAMES))).astype(np.float32),
            rng.uniform(0.001, 0.01, (n, len(NAMES))).astype(np.float32),
            list(NAMES))


def _routing_ds(n=60, seed=0):
    return RoutingDataset(*_arrays(n, seed))


def _service(router, **kw):
    return RouterService(router, {m: None for m in NAMES},
                         encoder=default_encoder("cpu"), **kw)


def _durable_service(root, *, delta_cap=500, **dur_kw):
    ds = _routing_ds()
    router = KNNRouter(k=4, index="ivf", n_clusters=4, online=True,
                       delta_cap=delta_cap, device="cpu").fit(ds)
    dur = DurabilityManager(root, device="cpu", **dur_kw)
    return _service(router, durability=dur), ds


def _feedback(ds, n=4, seed=1, hot=False):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, ds.dim)).astype(np.float32)
    S = rng.uniform(0.2, 1.0, (n, len(NAMES))).astype(np.float32)
    if hot:
        S[0, :] = 9.0
    C = rng.uniform(0.001, 0.01, S.shape).astype(np.float32)
    return emb, S, C


# ---------------------------------------------------------------------------
# write-ahead log
# ---------------------------------------------------------------------------

def test_wal_round_trip_and_reopen(tmp_path):
    wal = WriteAheadLog(tmp_path / "wal")
    batches = [_batch(seed=s) for s in range(3)]
    for b in batches:
        wal.append(*b)
    wal.close()
    wal2 = WriteAheadLog(tmp_path / "wal")
    assert wal2.next_seq == 3 and wal2.torn_tail_dropped == 0
    recs = list(wal2.records())
    assert [r.seq for r in recs] == [0, 1, 2]
    for r, (e, s, c) in zip(recs, batches):
        np.testing.assert_array_equal(r.emb, e)
        np.testing.assert_array_equal(r.scores, s)
        np.testing.assert_array_equal(r.costs, c)
    assert list(wal2.records(after_seq=1))[0].seq == 2


def test_wal_torn_tail_is_dropped_repaired_and_sequencing_continues(
        tmp_path):
    wal = WriteAheadLog(tmp_path / "wal")
    wal.append(*_batch(seed=0))
    wal.append(*_batch(seed=1))
    seg = wal._segments()[0][1]
    wal.close()
    size_before = seg.stat().st_size
    with open(seg, "ab") as f:
        f.write(b"RWAL" + b"\x07" * 9)
    wal2 = WriteAheadLog(tmp_path / "wal")
    assert wal2.torn_tail_dropped == 1
    assert seg.stat().st_size == size_before
    assert [r.seq for r in wal2.records()] == [0, 1]
    assert wal2.append(*_batch(seed=2)) == 2
    assert [r.seq for r in wal2.records()] == [0, 1, 2]


def test_wal_corruption_before_the_tail_is_fatal_not_silent(tmp_path):
    wal = WriteAheadLog(tmp_path / "wal", segment_max_bytes=1)
    for s in range(3):
        wal.append(*_batch(seed=s))
    wal.close()
    first_seg = wal._segments()[0][1]
    raw = bytearray(first_seg.read_bytes())
    raw[struct.calcsize("<4sIQI") + 5] ^= 0xFF
    first_seg.write_bytes(bytes(raw))
    with pytest.raises(WALCorruptError, match="CRC"):
        WriteAheadLog(tmp_path / "wal", segment_max_bytes=1)


def test_wal_prune_keeps_uncovered_and_active_segments(tmp_path):
    wal = WriteAheadLog(tmp_path / "wal", segment_max_bytes=1)
    for s in range(3):
        wal.append(*_batch(seed=s))
    assert len(wal._segments()) == 3
    assert wal.prune(covered_seq=1) == 2
    assert [r.seq for r in wal.records()] == [2]
    assert wal.prune(covered_seq=2) == 0
    wal.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wal_crosses_packages_with_equal_bytes(tmp_path, monkeypatch,
                                               writer):
    """The same records give the same segment bytes in both packages (the
    npz payload's zip timestamp pinned), and a log written by either reads
    in the other, torn-tail repair included."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    batches = [_batch(n=2 + s, seed=s) for s in range(3)]
    logs = {}
    for name, cls in (("port", WriteAheadLog), ("reference",
                                                jdur.WriteAheadLog)):
        wal = cls(tmp_path / name)
        for b in batches:
            wal.append(*b)
        wal.close()
        logs[name] = [p.read_bytes() for _, p in wal._segments()]
    assert logs["port"] == logs["reference"]
    reader = (jdur.WriteAheadLog if writer == "port" else WriteAheadLog)
    seg = sorted((tmp_path / writer).iterdir())[0]
    with open(seg, "ab") as f:
        f.write(b"RWAL\x01")                   # a torn tail
    wal = reader(tmp_path / writer)
    assert wal.torn_tail_dropped == 1 and wal.next_seq == 3
    for r, (e, s, c) in zip(wal.records(), batches):
        np.testing.assert_array_equal(r.emb, e)
        np.testing.assert_array_equal(r.scores, s)
        np.testing.assert_array_equal(r.costs, c)


# ---------------------------------------------------------------------------
# typed artifact corruption and the checkpoint store
# ---------------------------------------------------------------------------

def _saved_router(tmp_path):
    r = KNNRouter(k=4, index="ivf", n_clusters=4, device="cpu").fit(
        _routing_ds())
    path = tmp_path / "art"
    save_router(r, path, covered_wal_seq=7)
    return path


def test_manifest_records_wal_coverage_and_a_missing_field_is_typed(
        tmp_path):
    path = _saved_router(tmp_path)
    m = json.loads((path / "manifest.json").read_text())
    assert m["covered_wal_seq"] == 7
    del m["config"]
    (path / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ArtifactCorruptError) as ei:
        load_router(path, device="cpu")
    assert ei.value.field == "config"


def test_checkpoint_store_skips_corrupt_newest_never_loads_it(tmp_path):
    r = KNNRouter(k=4, index="ivf", n_clusters=4, device="cpu").fit(
        _routing_ds())
    store = CheckpointStore(tmp_path / "ck", device="cpu")
    store.save(r, covered_seq=0)
    store.save(r, covered_seq=3)
    newest = store.list()[0][1]
    (newest / "state.npz").write_bytes(b"garbage")
    router, covered, skipped = store.load_latest()
    assert router is not None and covered == 0
    assert router.device == torch.device("cpu")
    assert len(skipped) == 1 and "ckpt-000000000004" in skipped[0]


# ---------------------------------------------------------------------------
# observe(): validation before the WAL, checkpoint policy
# ---------------------------------------------------------------------------

def test_observe_validation_rejects_garbage_before_wal(tmp_path):
    svc, ds = _durable_service(tmp_path / "state")
    dur = svc.durability
    emb, S, C = _feedback(ds)
    with pytest.raises(FeedbackValidationError, match="empty batch"):
        svc.observe([], S)
    bad = emb.copy()
    bad[1, 2] = np.nan
    with pytest.raises(FeedbackValidationError, match="NaN"):
        svc.observe(bad, S)
    with pytest.raises(FeedbackValidationError, match="fitted dim"):
        svc.observe(emb[:, :-1], S)
    with pytest.raises(FeedbackValidationError, match="scores"):
        svc.observe(emb, S[:, :1])
    with pytest.raises(FeedbackValidationError, match="costs"):
        svc.observe(emb, S, C[:1])
    with pytest.raises(FeedbackValidationError, match="scores"):
        svc.observe(emb, np.full_like(S, np.inf))
    assert dur.wal.appended == 0 and dur.applied_seq == -1
    assert svc.observed == 0
    svc.observe(emb, S, C)
    assert dur.wal.appended == 1 and dur.applied_seq == 0
    assert issubclass(FeedbackValidationError, ValueError)
    # texts are embedded by the service's encoder
    svc.observe(["topic 1 example 3"], S[:1])
    assert dur.applied_seq == 1 and svc.observed == 5


def test_bootstrap_and_cadence_checkpoints_prune_wal(tmp_path):
    svc, ds = _durable_service(tmp_path / "state", checkpoint_every=2,
                               segment_max_bytes=1)
    dur = svc.durability
    assert [c for c, _ in dur.checkpoints.list()] == [-1]
    for i in range(4):
        svc.observe(*_feedback(ds, seed=i))
    assert [c for c, _ in dur.checkpoints.list()] == [3, 1]
    assert [r.seq for r in dur.wal.records()] == [2, 3]
    st = svc.stats()
    assert st["durability"]["checkpoints"]["written"] == 3
    assert st["observed"] == 16
    json.dumps(st)


def test_recluster_requests_checkpoint_without_cadence(tmp_path):
    svc, ds = _durable_service(tmp_path / "state", delta_cap=6,
                               checkpoint_every=10_000)
    dur = svc.durability
    assert dur.checkpoints_written == 1
    svc.observe(*_feedback(ds, n=4, seed=0), recluster="auto")
    assert dur.checkpoints_written == 1
    svc.observe(*_feedback(ds, n=4, seed=1), recluster="auto")
    assert svc.router._ivf.reclusters == 1
    assert dur.checkpoints_written == 2 and not dur.checkpoint_pending


def test_background_recluster_checkpoint_lands_on_close(tmp_path):
    svc, ds = _durable_service(tmp_path / "state", delta_cap=6,
                               checkpoint_every=10_000)
    dur = svc.durability
    for i in range(2):
        svc.observe(*_feedback(ds, n=4, seed=i), recluster="background")
    svc.close()
    assert svc.router._ivf.reclusters == 1
    assert dur.checkpoints_written == 2 and not dur.checkpoint_pending


# ---------------------------------------------------------------------------
# recovery lifecycle (in-process)
# ---------------------------------------------------------------------------

def test_recover_replays_wal_suffix_and_reports_progress(tmp_path):
    root = tmp_path / "state"
    svc, ds = _durable_service(root, checkpoint_every=2)
    batches = [_feedback(ds, seed=i, hot=(i == 2)) for i in range(3)]
    for b in batches:
        svc.observe(*b)
    support = svc.router.support_size
    s_ref, c_ref = svc.router.predict_utility(batches[2][0])
    del svc
    svc2 = RouterService.open_recovery(root, {m: None for m in NAMES},
                                       device="cpu",
                                       encoder=default_encoder("cpu"))
    rec = svc2.recovery_status()
    assert rec["status"] == "replaying" and rec["pending_batches"] == 1
    assert svc2.complete_recovery() == 1
    rec = svc2.recovery_status()
    assert rec["status"] == "ready" and rec["replayed_rows"] == 4
    assert svc2.router.support_size == support
    s2, c2 = svc2.router.predict_utility(batches[2][0])
    np.testing.assert_array_equal(s_ref, s2)
    np.testing.assert_array_equal(c_ref, c2)
    assert float(np.max(s2)) > 1.5


def test_recovery_without_any_checkpoint_is_a_clear_error(tmp_path):
    with pytest.raises(FileNotFoundError, match="no loadable checkpoint"):
        RouterService.open_recovery(tmp_path / "empty",
                                    {m: None for m in NAMES}, device="cpu")


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def test_reference_state_dir_recovers_in_the_port(tmp_path):
    """A durable reference service observes (one compaction, a pending
    tier, a WAL suffix past its last checkpoint) and stops without a clean
    shutdown; the port recovers the directory to the same support size and
    the same choices."""
    root = tmp_path / "state"
    args = _arrays()
    jr = JaxKNN(k=4, index="ivf", n_clusters=4, online=True,
                delta_cap=10).fit(JaxDataset(*args))
    jsvc = JaxService(jr, {m: None for m in NAMES},
                      durability=jdur.DurabilityManager(
                          root, checkpoint_every=3))
    ds = _routing_ds()
    batches = [_feedback(ds, seed=i, hot=(i == 4)) for i in range(5)]
    for b in batches:
        jsvc.observe(*b, recluster="auto")
    # the third batch's compaction checkpointed seq 2; seqs 3-4 are WAL only
    assert jr._ivf.reclusters == 1 and jr._ivf.delta_rows == 8
    jsvc.durability.close()
    svc = RouterService.recover(root, {m: None for m in NAMES},
                                device="cpu", encoder=default_encoder("cpu"))
    assert svc.recovery_status()["replayed_batches"] == 2
    assert svc.router._ivf.delta_rows == 8
    assert svc.router.support_size == jr.support_size
    Q = np.concatenate([b[0] for b in batches])
    lam = np.linspace(0, 20, len(Q)).astype(np.float32)
    t = svc.route_fused(Q, lam)
    j = jsvc.route_fused(Q, lam)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], atol=TOL)


def test_dynamic_checkpoints_load_both_ways(tmp_path):
    """A port checkpoint of a streaming router (a pending tier) loads in
    the reference, and the reference's in the port, predicting alike."""
    svc, ds = _durable_service(tmp_path / "state", delta_cap=500)
    svc.observe(*_feedback(ds, n=6, seed=2))
    path = svc.checkpoint()
    jr = jax_load(path)
    assert jr._ivf.delta_rows == 6
    Q = _feedback(ds, n=8, seed=9)[0]
    for a, b in zip(jr.predict_with_confidence(Q),
                    svc.router.predict_with_confidence(Q)):
        np.testing.assert_allclose(np.asarray(a), b, atol=TOL)
    store = jdur.CheckpointStore(tmp_path / "jck")
    store.save(jr, covered_seq=5)
    back = load_router(store.list()[0][1], device="cpu")
    assert back._ivf.delta_rows == 6
    np.testing.assert_array_equal(back._ivf.delta_x, svc.router._ivf.delta_x)
    for a, b in zip(back.predict_with_confidence(Q),
                    svc.router.predict_with_confidence(Q)):
        np.testing.assert_allclose(a, b, atol=TOL)


def test_atomic_write_leaves_no_turds(tmp_path):
    p = tmp_path / "out.json"
    persist.atomic_write_json(p, {"a": 1})
    persist.atomic_write_json(p, {"a": 2})
    assert json.loads(p.read_text()) == {"a": 2}
    assert [q.name for q in tmp_path.iterdir()] == ["out.json"]
