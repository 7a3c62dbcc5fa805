"""Kill-injection child of the port: one crashed-or-clean durable serving
process (the port's twin of ``scripts/kill_injection_child.py``).

    python -m repro_torch.launch.kill_child --root DIR --mode fresh \\
        --device cpu --batches 6 --recluster auto

``--mode fresh`` (with ``REPRO_KILL_AT=<barrier>`` and optionally
``REPRO_KILL_AFTER=<n>`` in the environment) boots a durable
`RouterService` over a deterministic tiny corpus, streams ``observe()``
batches, and prints a flushed ``ACK seq=<n>`` line after every
acknowledged batch until the armed barrier (`repro_torch.persist`)
SIGKILLs it.  Batch i is the same bytes in every process, derived from
``--seed``.  ``--mode recover`` (unarmed) in the same ``--root`` recovers
through checkpoint + WAL replay and prints ``RECOVERY`` / ``RECOVERED``
lines, a ``FINGERPRINT`` (sha256 over ``predict_utility`` bytes on a probe
set and every applied batch) and a ``PROBE`` of the last applied batch's
hot row.  A third, uncrashed ``--mode fresh`` run with ``--batches`` set to
the recovered count must print the same fingerprint.  The corpus and the
router are the reference child's; embeddings come from the port's encoder.
"""
from __future__ import annotations

import argparse
import hashlib
import sys

import numpy as np

MODELS = ["model-a", "model-b"]
#: hot-row judged score: retrieving the row lifts the probe's predicted
#: score far above anything the base corpus (scores <= 1.0) can produce
HOT_SCORE = 9.0


def make_dataset(seed: int, device: str):
    from repro_torch.core.dataset import RoutingDataset
    from repro_torch.serving.encoder import default_encoder
    texts = [f"topic {i % 3} example {i}" for i in range(40)]
    emb = default_encoder(device).embed_texts(texts)
    rng = np.random.default_rng(seed)
    n, M = len(texts), len(MODELS)
    return RoutingDataset(
        "kill-mini", emb,
        rng.uniform(0.2, 1.0, (n, M)).astype(np.float32),
        rng.uniform(0.001, 0.01, (n, M)).astype(np.float32),
        list(MODELS))


def make_batch(seed: int, i: int, batch_size: int, dim: int):
    """Observation batch i, the same bytes in every process.  Row 0 is the
    hot row: judged HOT_SCORE everywhere."""
    rng = np.random.default_rng(seed * 100003 + i)
    emb = rng.normal(size=(batch_size, dim)).astype(np.float32)
    S = rng.uniform(0.2, 1.0, (batch_size, len(MODELS))).astype(np.float32)
    S[0, :] = HOT_SCORE
    C = rng.uniform(0.001, 0.01, S.shape).astype(np.float32)
    return emb, S, C


def fingerprint(router, seed: int, n_batches: int, batch_size: int,
                dim: int) -> str:
    """sha256 over predict_utility bytes on a fixed probe set plus every
    applied batch's embeddings: retrieval identity, not just counts."""
    probes = [np.random.default_rng(987).normal(
        size=(8, dim)).astype(np.float32)]
    for i in range(n_batches):
        probes.append(make_batch(seed, i, batch_size, dim)[0])
    s, c = router.predict_utility(np.concatenate(probes, axis=0))
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(s, np.float32)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(c, np.float32)).tobytes())
    return h.hexdigest()


def probe_hot_row(router, seed: int, applied_seq: int, batch_size: int,
                  dim: int) -> float:
    """Predicted score of the last applied batch's hot row: > 1.5 iff the
    observed row is retrieved (k = 4 uniform averages of base scores stay
    below 1.0)."""
    emb, _, _ = make_batch(seed, applied_seq, batch_size, dim)
    s, _ = router.predict_utility(emb[:1])
    return float(np.max(np.asarray(s)))


def build_service(args):
    from repro_torch.core.routers.knn import KNNRouter
    from repro_torch.serving.durability import DurabilityManager
    from repro_torch.serving.encoder import default_encoder
    from repro_torch.serving.router_service import RouterService
    ds = make_dataset(args.seed, args.device)
    router = KNNRouter(k=4, index="ivf", n_clusters=4, nprobe=4,
                       online=True, delta_cap=args.delta_cap,
                       device=args.device).fit(ds, seed=args.seed)
    dur = DurabilityManager(args.root, checkpoint_every=args.checkpoint_every,
                            device=args.device)
    return RouterService(router, {m: None for m in MODELS},
                         durability=dur,
                         encoder=default_encoder(args.device)), ds.dim


def say(line: str) -> None:
    print(line, flush=True)      # flushed: must survive a SIGKILL right after


def run_fresh(args) -> int:
    svc, dim = build_service(args)
    say(f"BOOT support={svc.router.support_size}")
    for i in range(args.batches):
        emb, S, C = make_batch(args.seed, i, args.batch_size, dim)
        svc.observe(emb, S, C, recluster=args.recluster)
        # printed only after observe returned, i.e. after the WAL fsync:
        # the parent treats every printed seq as durable
        say(f"ACK seq={i} support={svc.router.support_size}")
    svc.close()                  # joins a background compaction, if any
    applied = args.batches
    fp = fingerprint(svc.router, args.seed, applied, args.batch_size, dim)
    say(f"FINGERPRINT {fp}")
    hot = probe_hot_row(svc.router, args.seed, applied - 1, args.batch_size,
                        dim)
    say(f"PROBE {hot:.3f}")
    say("DONE")
    return 0


def run_recover(args) -> int:
    from repro_torch.serving.encoder import default_encoder
    from repro_torch.serving.router_service import RouterService
    svc = RouterService.open_recovery(args.root, {m: None for m in MODELS},
                                      device=args.device,
                                      encoder=default_encoder(args.device))
    rec = svc.recovery_status()
    say(f"RECOVERY covered={rec['checkpoint_covered_seq']} "
        f"pending={rec['pending_batches']} "
        f"skipped={rec['corrupt_checkpoints_skipped']} "
        f"torn={rec['wal_torn_tail_dropped']}")
    svc.complete_recovery(recluster="auto")
    applied = svc.durability.applied_seq + 1
    dim = int(svc.router._X.shape[1])
    say(f"RECOVERED applied={applied} support={svc.router.support_size}")
    fp = fingerprint(svc.router, args.seed, applied, args.batch_size, dim)
    say(f"FINGERPRINT {fp}")
    if applied > 0:
        hot = probe_hot_row(svc.router, args.seed, applied - 1,
                            args.batch_size, dim)
        say(f"PROBE {hot:.3f}")
    say("DONE")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--root", required=True, help="durability root dir")
    ap.add_argument("--mode", choices=("fresh", "recover"), required=True)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--recluster", default="auto",
                    help='"auto" (deterministic, fingerprint-comparable) '
                         'or "background" (the compaction thread\'s '
                         'barriers)')
    ap.add_argument("--delta-cap", type=int, default=10)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="where the router and encoder run (default: the "
                         "card; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    if args.recluster in ("0", "false", "False"):
        args.recluster = False
    return (run_fresh if args.mode == "fresh" else run_recover)(args)


if __name__ == "__main__":
    sys.exit(main())
