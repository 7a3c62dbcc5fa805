"""Practitioner diagnostics from §7-§8: the delta-locality check (Fig. 1),
the TwoNN intrinsic-dimension estimator, and per-query kNN confidence.
A numpy copy of the JAX package's `repro.core.diagnostics`."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def locality_check(embeddings: np.ndarray, scores: np.ndarray,
                   n_pairs: int = 20000, n_bins: int = 20,
                   seed: int = 0) -> Dict:
    """Correlation between embedding distance and model-performance agreement
    (Fig. 1).  Agreement = Pearson correlation of the two queries' score
    vectors across models; pairs are binned by distance.

    Returns dict(bin_centers, bin_agreement, pearson_r)."""
    rng = np.random.default_rng(seed)
    n = len(embeddings)
    i = rng.integers(0, n, n_pairs)
    j = rng.integers(0, n, n_pairs)
    keep = i != j
    i, j = i[keep], j[keep]
    d = np.linalg.norm(embeddings[i] - embeddings[j], axis=1)

    si = scores[i] - scores[i].mean(1, keepdims=True)
    sj = scores[j] - scores[j].mean(1, keepdims=True)
    num = (si * sj).sum(1)
    den = np.sqrt((si ** 2).sum(1) * (sj ** 2).sum(1))
    ok = den > 1e-9
    agree = np.where(ok, num / np.maximum(den, 1e-9), 0.0)

    edges = np.quantile(d, np.linspace(0, 1, n_bins + 1))
    centers, means = [], []
    for b in range(n_bins):
        m = (d >= edges[b]) & (d <= edges[b + 1])
        if m.sum() > 5:
            centers.append(d[m].mean())
            means.append(agree[m].mean())
    centers = np.array(centers)
    means = np.array(means)
    if len(centers) > 2 and centers.std() > 0 and means.std() > 0:
        r = float(np.corrcoef(centers, means)[0, 1])
    else:
        r = 0.0
    return {"bin_centers": centers, "bin_agreement": means, "pearson_r": r}


def twonn_intrinsic_dim(embeddings: np.ndarray, max_n: int = 4000,
                        seed: int = 0) -> float:
    """Facco et al. (2017) TwoNN MLE: id = N / sum(log(r2/r1))."""
    rng = np.random.default_rng(seed)
    X = embeddings
    if len(X) > max_n:
        X = X[rng.choice(len(X), max_n, replace=False)]
    n = len(X)
    # pairwise distances in blocks (avoid n^2 memory blowup for big n)
    mus = []
    block = 512
    norms = (X ** 2).sum(1)
    for i in range(0, n, block):
        xb = X[i: i + block]
        d2 = norms[i: i + block, None] + norms[None, :] - 2 * xb @ X.T
        d2 = np.maximum(d2, 0)
        d2[np.arange(len(xb)), i + np.arange(len(xb))] = np.inf
        part = np.partition(d2, 1, axis=1)[:, :2]
        r1 = np.sqrt(part[:, 0])
        r2 = np.sqrt(part[:, 1])
        ok = r1 > 1e-12
        mus.append(np.log(np.maximum(r2[ok] / r1[ok], 1 + 1e-12)))
    mu = np.concatenate(mus)
    return float(len(mu) / mu.sum())


def knn_confidence(kth_similarity: np.ndarray,
                   train_kth: np.ndarray) -> np.ndarray:
    """Per-query confidence: percentile of the query's kth-neighbour
    similarity within the training distribution (low => sparse coverage,
    §8 'warrant caution or fallback')."""
    order = np.sort(train_kth)
    ranks = np.searchsorted(order, kth_similarity) / max(len(order), 1)
    return ranks
