"""Seeded synthetic routing-benchmark generator: a copy of the JAX
package's `repro.data.synthetic` (numpy only), so both packages generate
the same datasets byte for byte.

The leaderboard evaluations the paper aggregates (AlpacaEval / HELM-Lite /
OpenLLM / RouterBench / vHELM responses + scores) are not shipped with the
repository, so we SIMULATE them with a generative process that embeds
the exact structure the paper studies:

  * queries live on a low intrinsic-dimension manifold (latent dim d_int)
    embedded into the ambient space by a random linear map -> TwoNN on the
    result reproduces the paper's d ~ 2-28 regime;
  * model performance is a SMOOTH function of the latent (random Fourier
    features + per-cluster affinities) -> delta-locality (Def 7.1) holds by
    construction, with a `locality` knob trading smooth signal vs iid noise;
  * model quality baselines correlate with price (stronger models cost
    more) -> a real cost/performance Pareto frontier;
  * costs follow the paper's cost model  c = in_tok * p_in + out_tok * p_out
    with per-query lognormal input lengths and per-model output verbosity,
    using the VERBATIM Appendix-B price tables.

Binary-metric tasks (accuracy benchmarks) Bernoulli-sample the smooth success
probability — precisely the regime where kNN's neighbourhood averaging wins.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.dataset import RoutingDataset


@dataclass
class GenSpec:
    name: str
    models: Dict[str, tuple]          # name -> (p_in, p_out) $/1M tokens
    n_queries: int = 2000
    ambient_dim: int = 768
    latent_dim: int = 8
    n_clusters: int = 6
    locality: float = 0.9             # weight of smooth vs iid noise
    binary: bool = True               # Bernoulli-sample scores
    embed_noise: float = 0.02
    rff_features: int = 64
    linear_frac: float = 0.5          # linear vs RFF share of the skill surface
    price_skill: float = 0.55         # correlation of quality with log-price
    cluster_offset: float = 0.0       # shifts latent clusters (OOD control)
    seed: int = 0


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def generate(spec: GenSpec) -> RoutingDataset:
    rng = np.random.default_rng(spec.seed)
    M = len(spec.models)
    names = list(spec.models)
    p_in = np.array([spec.models[m][0] for m in names])
    p_out = np.array([spec.models[m][1] for m in names])

    # ---- latent queries on a low-dim manifold ----
    centers = rng.normal(size=(spec.n_clusters, spec.latent_dim)) * 1.5
    centers += spec.cluster_offset
    cl = rng.integers(0, spec.n_clusters, spec.n_queries)
    z = centers[cl] + rng.normal(size=(spec.n_queries, spec.latent_dim)) * 0.6

    # ---- ambient embeddings: random linear map + noise ----
    A = rng.normal(size=(spec.latent_dim, spec.ambient_dim))
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    emb = z @ A + rng.normal(size=(spec.n_queries, spec.ambient_dim)) \
        * spec.embed_noise
    emb = emb.astype(np.float32)

    # ---- smooth per-model skill surfaces (random Fourier features) ----
    W = rng.normal(size=(spec.latent_dim, spec.rff_features)) * 0.8
    b = rng.uniform(0, 2 * np.pi, spec.rff_features)
    phi = np.cos(z @ W + b) * np.sqrt(2.0 / spec.rff_features)

    log_price = np.log1p(p_in + p_out)
    base_quality = spec.price_skill * (
        (log_price - log_price.mean()) / (log_price.std() + 1e-9))
    base_quality += rng.normal(size=M) * 0.35          # idiosyncratic skill

    w_m = rng.normal(size=(spec.rff_features, M)) * 1.2
    v_m = rng.normal(size=(spec.latent_dim, M)) * 0.6   # linear skill part
    aff = rng.normal(size=(spec.n_clusters, M)) * 0.8  # cluster specialties

    smooth = (spec.linear_frac * (z @ v_m)
              + (1 - spec.linear_frac) * (phi @ w_m)
              + aff[cl] + base_quality[None, :])
    noise = rng.normal(size=(spec.n_queries, M))
    logits = (spec.locality * smooth
              + (1 - spec.locality) * noise * 2.0)
    probs = _sigmoid(logits)

    if spec.binary:
        scores = (rng.uniform(size=probs.shape) < probs).astype(np.float32)
    else:
        scores = np.clip(probs + rng.normal(size=probs.shape) * 0.03,
                         0, 1).astype(np.float32)

    # ---- costs: paper Appendix-B cost model ----
    in_tok = np.exp(rng.normal(np.log(400), 0.6, spec.n_queries))
    verbosity = np.exp(rng.normal(0.0, 0.25, M))       # per-model out length
    out_tok = np.exp(rng.normal(np.log(250), 0.4,
                                (spec.n_queries, M))) * verbosity[None, :]
    costs = (in_tok[:, None] * p_in[None, :]
             + out_tok * p_out[None, :]) / 1e6
    costs = costs.astype(np.float32)

    ds = RoutingDataset(spec.name, emb, scores, costs, names)
    ds.split(seed=spec.seed)
    return ds


def embedding_variant(ds: RoutingDataset, ambient_dim: int,
                      embed_noise: float, seed: int = 0,
                      name_suffix: str = "-sfr") -> RoutingDataset:
    """Same queries/scores/costs, different embedding space (Table I.1):
    re-embed by random rotation into a new ambient dim with different SNR.
    We recover the latent via PCA of the original embeddings (the generator's
    linear map makes this exact up to rotation)."""
    rng = np.random.default_rng(seed)
    X = ds.embeddings - ds.embeddings.mean(0, keepdims=True)
    # top components capture the latent manifold
    u, s, vt = np.linalg.svd(X, full_matrices=False)
    k = min(32, X.shape[1])
    lat = u[:, :k] * s[:k]
    A = rng.normal(size=(k, ambient_dim))
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    emb = lat @ A + rng.normal(size=(len(X), ambient_dim)) * embed_noise
    out = RoutingDataset(ds.name + name_suffix, emb.astype(np.float32),
                         ds.scores.copy(), ds.costs.copy(),
                         list(ds.model_names),
                         train_idx=ds.train_idx.copy(),
                         val_idx=ds.val_idx.copy(),
                         test_idx=ds.test_idx.copy())
    return out
