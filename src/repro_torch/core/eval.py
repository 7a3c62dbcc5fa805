"""Evaluation protocols (§4.3, B.3).

Utility prediction: sweep the trade-off parameter lambda over a wide grid,
route by predicted utility, record ACTUAL (cost, performance) per lambda,
take the non-decreasing convex hull in the cost-performance plane, report its
AUC on axes normalized to cost in [0, 1] and performance in [0, 100].

Selection-based: utility score  s - lam*c  at the three paper presets
(lam = 1.0/c_max, 0.5/c_max, 0.1/c_max), reported x100.

A copy of the JAX package's `repro.core.eval`: the hull arithmetic is
numpy, so both packages give the same AUC bits on the same predictions.
The port's routers compute ``predict_utility`` / ``select`` on their
device and return numpy, which these functions take as they are.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .dataset import RoutingDataset


def lambda_grid(c_ref: float, n: int = 41) -> np.ndarray:
    """0 plus a log grid spanning 'performance-only' to 'cost-dominated'."""
    lg = np.logspace(-4, 2, n - 1) / max(c_ref, 1e-12)
    return np.concatenate([[0.0], lg])


def _route_points(s_hat, c_hat, s_true, c_true, lambdas):
    """For each lambda: mean ACTUAL (cost, perf) of predicted-utility argmax."""
    pts = []
    for lam in lambdas:
        choice = np.argmax(s_hat - lam * c_hat, axis=1)
        rows = np.arange(len(choice))
        pts.append((c_true[rows, choice].mean(), s_true[rows, choice].mean()))
    return np.array(pts)  # (L, 2) cost, perf


def nondecreasing_hull(points: np.ndarray) -> np.ndarray:
    """Upper-left frontier: sort by cost, keep points that strictly improve
    performance, then prune to the concave (convex-hull upper) envelope."""
    pts = points[np.argsort(points[:, 0], kind="stable")]
    frontier = []
    best = -np.inf
    for c, s in pts:
        if s > best + 1e-12:
            frontier.append((c, s))
            best = s
    # concave envelope (upper hull) via monotone-chain cross products
    hull = []
    for p in frontier:
        while len(hull) >= 2:
            (x1, y1), (x2, y2) = hull[-2], hull[-1]
            if (x2 - x1) * (p[1] - y1) - (y2 - y1) * (p[0] - x1) >= 0:
                hull.pop()
            else:
                break
        hull.append(p)
    return np.array(hull)


def hull_auc(points: np.ndarray, c_norm: float) -> float:
    """AUC of the non-decreasing hull on cost in [0,1] (normalized by c_norm)
    and perf scaled x100.  Performance is 0 left of the cheapest point and
    constant right of the most expensive one."""
    hull = nondecreasing_hull(points)
    cs = np.clip(hull[:, 0] / max(c_norm, 1e-12), 0, 1)
    ss = hull[:, 1] * 100.0
    auc = 0.0
    # piecewise-linear between hull vertices
    for i in range(len(cs) - 1):
        auc += 0.5 * (ss[i] + ss[i + 1]) * (cs[i + 1] - cs[i])
    auc += ss[-1] * (1.0 - cs[-1])          # constant extension to cost 1
    return float(auc)


def cost_normalizer(ds: RoutingDataset, split: str = "test") -> float:
    """Mean per-query cost of the most expensive single model on the split."""
    _, _, C = ds.part(split)
    return float(C.mean(axis=0).max())


def utility_auc(router, ds: RoutingDataset, split: str = "test",
                lambdas: Optional[np.ndarray] = None) -> Dict:
    X, S, C = ds.part(split)
    s_hat, c_hat = router.predict_utility(X)
    c_ref = float(C.mean(axis=0).max())
    if lambdas is None:
        lambdas = lambda_grid(C.mean())
    pts = _route_points(s_hat, c_hat, S, C, lambdas)
    auc = hull_auc(pts, c_ref)
    return {"auc": auc, "points": pts, "c_ref": c_ref}


def oracle_auc(ds: RoutingDataset, split: str = "test") -> Dict:
    X, S, C = ds.part(split)
    c_ref = float(C.mean(axis=0).max())
    pts = _route_points(S, C, S, C, lambda_grid(C.mean()))
    return {"auc": hull_auc(pts, c_ref), "points": pts, "c_ref": c_ref}


def random_auc(ds: RoutingDataset, split: str = "test", n_draws: int = 32,
               seed: int = 0) -> Dict:
    X, S, C = ds.part(split)
    rng = np.random.default_rng(seed)
    c_ref = float(C.mean(axis=0).max())
    pts = []
    for _ in range(n_draws):
        choice = rng.integers(0, ds.n_models, size=len(S))
        rows = np.arange(len(S))
        pts.append((C[rows, choice].mean(), S[rows, choice].mean()))
    return {"auc": hull_auc(np.array(pts), c_ref), "points": np.array(pts),
            "c_ref": c_ref}


# ---------------------------------------------------------------------------
# selection-based evaluation (Appendix D)
# ---------------------------------------------------------------------------

PRESETS = {"high-performance": 0.1, "balanced": 0.5, "low-cost": 1.0}


def selection_utility(router_factory, ds: RoutingDataset,
                      split: str = "test", seed: int = 0) -> Dict[str, float]:
    """router_factory() -> fresh Router; trains one per preset lambda.
    Returns utility x100 per preset plus the average."""
    X, S, C = ds.part(split)
    out = {}
    for name, mult in PRESETS.items():
        lam = mult / ds.c_max
        r = router_factory()
        r.fit_selection(ds, lam, seed=seed)
        choice = r.select(X)
        rows = np.arange(len(choice))
        util = (S[rows, choice] - lam * C[rows, choice]).mean()
        out[name] = float(util * 100.0)
    out["avg"] = float(np.mean([out[k] for k in PRESETS]))
    return out
