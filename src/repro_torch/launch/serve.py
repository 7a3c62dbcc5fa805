"""Routed-serving entry point of the port (mirrors `repro.launch.serve`): build
a pool of engines, fit a spec-addressed kNN router on a synthetic routing
support set in the query encoder's embedding space, then serve a stream of
text requests at per-request cost/quality lambdas.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --pool qwen3-4b mamba2-370m h2o-danube-1.8b --requests 8 \\
      --router knn100-ivfpq --save-artifact /tmp/r

Engines are reduced configs, as in the reference CLI (`chip_smoke.py`
serves the published widths).  ``--device cpu`` runs everything with the
kernels' plain versions.  With ``--save-artifact`` the fitted router is
persisted (npz + manifest, the reference's format) and the service is
re-booted from the artifact before serving.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core.dataset import RoutingDataset
from repro_torch.serving import encoder as enc
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.pipeline import RoutingPipeline
from repro_torch.serving.router_service import RouterService

TOPICS = ["python programming", "world history", "algebra proofs",
          "poetry writing", "biology facts"]


def build_support(pool, n=300, seed=0, encoder=None):
    """Synthetic routing support set in the ENCODER's embedding space: each
    pool model is strong on some topics (smooth in embedding space).  The
    same numbers as the reference's `build_support` for the same encoder
    weights."""
    encoder = encoder or enc.default_encoder()
    rng = np.random.default_rng(seed)
    texts = [f"{TOPICS[i % len(TOPICS)]} question {i}" for i in range(n)]
    emb = encoder.embed_texts(texts)
    M = len(pool)
    affinity = rng.uniform(0.2, 1.0, (len(TOPICS), M))
    topic = np.array([i % len(TOPICS) for i in range(n)])
    scores = np.clip(affinity[topic] + rng.normal(0, 0.05, (n, M)), 0, 1)
    costs = np.tile(rng.uniform(0.001, 0.01, M), (n, 1)).astype(np.float32)
    return RoutingDataset("serve-support", emb, scores.astype(np.float32),
                          costs, list(pool))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", nargs="+",
                    default=["qwen3-4b", "mamba2-370m", "h2o-danube-1.8b"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--router", default="knn10",
                    help="router spec string, e.g. knn10, "
                         "knn100-ivfpq@lam=0.5")
    ap.add_argument("--save-artifact", default=None,
                    help="persist the fitted router here and re-boot the "
                         "service from the artifact before serving")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engines = {}
    for i, name in enumerate(args.pool):
        cfg = reduced(get_config(name))
        engines[name] = ServingEngine(cfg, max_slots=2, cache_len=64, seed=i,
                                      device=args.device)
        print(f"[pool] {name}: reduced {cfg.total_blocks()} blocks")

    encoder = enc.default_encoder(args.device)
    ds = build_support(args.pool, encoder=encoder)
    pipe = RoutingPipeline(args.router, device=args.device).fit(ds)
    if args.save_artifact:
        path = pipe.save(args.save_artifact)
        print(f"[artifact] saved {pipe.spec} -> {path}")
        svc = RouterService.from_artifact(path, engines, device=args.device,
                                          fallback_model=args.pool[0],
                                          encoder=encoder)
    else:
        svc = pipe.serve(engines, fallback_model=args.pool[0],
                         encoder=encoder)

    reqs = [f"{TOPICS[i % len(TOPICS)]} request number {i}"
            for i in range(args.requests)]
    # per-request lambda: even requests at the CLI trade-off, odd requests
    # quality-first (lam=0): one batch, two operating points
    lams = np.where(np.arange(len(reqs)) % 2 == 0, args.lam, 0.0)
    results = svc.serve_texts(reqs, max_new_tokens=args.max_new,
                              lam=lams.astype(np.float32))
    for r in results:
        print(f"  req {r.uid} -> {r.model:24s} s_hat={r.predicted_score:.2f} "
              f"lam={r.lam:.2f} conf={r.confidence:.2f} "
              f"tokens={r.request.output_tokens}")
    counts = {}
    for r in results:
        counts[r.model] = counts.get(r.model, 0) + 1
    print("[routing mix]", counts)
    return results


if __name__ == "__main__":
    main()
