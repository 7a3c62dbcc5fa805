"""Measured dispatch policy: which retrieval backend serves which batch
(a copy of `repro.core.routers.dispatch`, kept here so the port imports
nothing of `repro`).

The policy turns a serving benchmark's measurements into a small fitted
table:

    (index kind x batch bucket x delta fraction)  ->  policy backend

plus a **wave-close timeout** derived from the measured batch-amortization
curve (how long a `MicroBatcher` may hold a wave open: at most one
single-dispatch time, which bounds an idle stream's latency penalty at
about 2x while a loaded stream fills the wave) and the **autotuned kernel
tile constants** (``lane_pad`` / ``block_q`` / ``probe_chunk``).

The policy is persisted inside the router artifact (format_version 5 and
later; older artifacts load with no policy) and consulted at serve time by
`KNNRouter.resolve_backend` / `MicroBatcher.from_policy`.  A policy written
by either package loads in the other as an equal `DispatchPolicy`.

Policy backend names are *serving strategies*, not raw kernel names:

    fused        retrieval and the decision tail in one dispatch
    host_gather  retrieval by the host inverted traversal (or the separate
                 exact-scan dispatch on ``index="exact"``), then the fused
                 decision tail
    staged       retrieval by the tiled twin, then the fused decision tail

The mapping to `KNNRouter` execution backends is `EXEC_BACKEND`.  In the
port every execution backend of one index runs the same kernels on a CUDA
router (their plain versions on a CPU router), so a policy's backend
choice changes no result and no kernel; its wave constants and
``lane_pad`` do take effect.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

#: the serving strategies a policy cell may choose between
POLICY_BACKENDS = ("fused", "host_gather", "staged")

#: policy backend name -> `KNNRouter` execution backend (``backend=`` value).
#: The policy chooses the RETRIEVAL stage only; every choice shares the same
#: fused decision tail, so routing decisions are identical across cells.
EXEC_BACKEND = {"fused": "fused", "host_gather": "host", "staged": "tiles"}


def _dkey(frac: float) -> str:
    """Canonical JSON-safe key for a delta-fraction edge."""
    return format(float(frac), ".6g")


def _bucket(edges: Sequence, value) -> Optional[str]:
    """Smallest edge >= value, else the largest edge (the table's coarsest
    cell covers everything beyond what was measured)."""
    if not edges:
        return None
    for e in edges:
        if value <= e:
            return e
    return edges[-1]


@dataclasses.dataclass
class DispatchPolicy:
    """A fitted (index x batch x delta) -> backend table plus the wave and
    tile constants that ride along.  JSON-round-trippable via
    ``to_dict`` / ``from_dict`` (the artifact manifest embeds it verbatim).

    ``cells`` is ``{index: {str(batch_edge): {delta_key: backend}}}`` with
    string keys throughout so the structure IS its JSON form."""

    cells: Dict[str, Dict[str, Dict[str, str]]]
    batch_edges: Tuple[int, ...] = ()
    delta_edges: Tuple[float, ...] = (0.0,)
    wave_close_timeout_s: float = 0.0
    wave_target_batch: int = 0
    tiles: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    fitted_from: Dict = dataclasses.field(default_factory=dict)

    # ---- lookup ----
    def backend_for(self, index: str, n_queries: int,
                    delta_frac: float = 0.0) -> Optional[str]:
        """Policy backend for a batch of ``n_queries`` against ``index``
        with ``delta_frac`` of the rows in the streaming delta tier, or
        ``None`` when the table has no cell for this index (callers keep
        their static default).  Batches/fractions between measured edges
        round UP to the next measured cell; beyond the largest edge the
        coarsest cell applies."""
        table = self.cells.get(index)
        if not table:
            return None
        be = _bucket([int(b) for b in self.batch_edges], int(n_queries))
        cell = table.get(str(be)) or table.get(
            max(table, key=int))                  # edge set drifted: coarsest
        if not cell:
            return None
        de = _bucket(list(self.delta_edges), float(delta_frac))
        return cell.get(_dkey(de)) or cell.get(_dkey(0.0)) or next(
            iter(cell.values()))

    def exec_backend_for(self, index: str, n_queries: int,
                         delta_frac: float = 0.0) -> Optional[str]:
        """`backend_for` mapped onto `KNNRouter` execution backends."""
        be = self.backend_for(index, n_queries, delta_frac)
        return None if be is None else EXEC_BACKEND[be]

    def tiles_for(self, index: str) -> Dict[str, int]:
        """Autotuned kernel constants for ``index`` (may be empty)."""
        return self.tiles.get(index, {})

    # ---- (de)serialization: the manifest embeds this verbatim ----
    def to_dict(self) -> dict:
        return {"cells": self.cells,
                "batch_edges": [int(b) for b in self.batch_edges],
                "delta_edges": [float(d) for d in self.delta_edges],
                "wave_close_timeout_s": float(self.wave_close_timeout_s),
                "wave_target_batch": int(self.wave_target_batch),
                "tiles": self.tiles,
                "fitted_from": self.fitted_from}

    @classmethod
    def from_dict(cls, d: dict) -> "DispatchPolicy":
        return cls(cells=d.get("cells", {}),
                   batch_edges=tuple(int(b) for b in
                                     d.get("batch_edges", ())),
                   delta_edges=tuple(float(x) for x in
                                     d.get("delta_edges", (0.0,))),
                   wave_close_timeout_s=float(
                       d.get("wave_close_timeout_s", 0.0)),
                   wave_target_batch=int(d.get("wave_target_batch", 0)),
                   tiles=d.get("tiles", {}),
                   fitted_from=d.get("fitted_from", {}))


def _wave_constants(measured: List[dict]) -> Tuple[float, int]:
    """(wave_close_timeout_s, wave_target_batch) from the measured batch
    amortization curve of the index kind with the most batch points
    (delta-free cells only).

    Target batch = the batch whose BEST backend minimizes per-request p50 —
    the knee of the amortization curve, past which wider waves stop paying.
    Timeout = the best single-request dispatch p50: a wave held open that
    long costs an idle request at most ~2x its solo latency, while a loaded
    stream fills the wave well before the timer and gets the full
    amortization."""
    by_index: Dict[str, Dict[int, float]] = {}
    for c in measured:
        if c.get("delta_frac", 0.0):
            continue
        best = min(v["p50_s"] for v in c["backends"].values())
        by_index.setdefault(c["index"], {})[int(c["batch"])] = best
    if not by_index:
        return 0.0, 0
    curve = max(by_index.values(), key=len)
    if len(curve) < 2:
        return 0.0, 0
    target = min(curve, key=lambda b: curve[b] / b)
    timeout = curve.get(1, min(curve.values()))
    return float(timeout), int(target)


def fit_dispatch_policy(measured: List[dict], *, tiles: Optional[dict] = None,
                        fitted_from: Optional[dict] = None) -> DispatchPolicy:
    """Fit the table from measured cells.  Each element of ``measured``::

        {"index": "ivfpq", "batch": 64, "delta_frac": 0.0,
         "backends": {"fused": {"p50_s": ...}, "host_gather": {...}, ...}}

    Per cell the argmin-p50 backend wins — the policy is exactly the lower
    envelope of the measured Pareto points, so by construction every chosen
    cell is within timing noise of the best measured backend (the property
    ``serving_latency --check`` re-measures and enforces)."""
    cells: Dict[str, Dict[str, Dict[str, str]]] = {}
    batch_edges = sorted({int(c["batch"]) for c in measured})
    delta_edges = sorted({float(c.get("delta_frac", 0.0)) for c in measured})
    for c in measured:
        best = min(c["backends"].items(), key=lambda kv: kv[1]["p50_s"])[0]
        if best not in POLICY_BACKENDS:
            raise ValueError(f"unknown policy backend {best!r} in measured "
                             f"cell {c['index']}/b{c['batch']}")
        (cells.setdefault(c["index"], {})
              .setdefault(str(int(c["batch"])), {})
         )[_dkey(c.get("delta_frac", 0.0))] = best
    timeout, target = _wave_constants(measured)
    return DispatchPolicy(cells=cells, batch_edges=tuple(batch_edges),
                          delta_edges=tuple(delta_edges),
                          wave_close_timeout_s=timeout,
                          wave_target_batch=target,
                          tiles=tiles or {},
                          fitted_from=fitted_from or {})
