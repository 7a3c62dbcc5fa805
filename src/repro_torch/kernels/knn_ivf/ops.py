"""IVF / IVF-PQ index build and search of the port (mirrors
`repro.kernels.knn_ivf.ops`).

``build_ivf_index`` fits a spherical k-means coarse quantizer in numpy (once,
at ``KNNRouter.fit``) and lays the support set out cluster-major:
``sup_cm (C, L, D)`` raw rows zero-padded to the list length L, ``ids_cm
(C, L)`` original row ids with -1 padding, ``inv_cm (C, L)`` inverse row
norms with 0 padding.  Oversized clusters are recursively halved along
their top principal direction until every list fits ``balance * N/C`` rows.
``build_ivfpq_index`` keeps the same partition and stores packed PQ codes
of the rows' residuals code-major ``(C, MB, L)`` (`pq.py`), plus the raw
rows as the flat cold tier ``sup_flat`` that the exact re-rank reads.  The
numpy build is the reference's (its k-means loops group a cluster's
members by one stable sort, which selects the same rows in the same order
as the reference's mask a cluster), so both packages give the same bytes
from the same rows and seed.

Search: ``ivf_topk`` probes each query's ``nprobe`` nearest centroids
(`ref.ivf_probe`) and runs kernel 4 (`ivf_scan`: `kernel.cu`) over the
probed lists; ``ivfpq_topk`` runs kernel 5 (`ivfpq_adc`: `pq_kernel.cu`)
for an ADC shortlist of ``rerank * k`` candidates, then re-scores the
shortlist exactly against the cold rows with the stored inverse norms
(`rerank_stored_inv`, the reference's fused serving form) and keeps the top
k.  Each kernel wrapper runs its plain version (`ref.py`) for CPU tensors
and launches its kernel for CUDA tensors, or raises.

``DynamicIVFIndex`` makes either frozen index a STREAMING one, with the
reference's semantics: ``append`` assigns each new row to its nearest
coarse centroid and stores it in a delta tier; ``recluster`` compacts the
tier into a fresh build over every row (synchronously, or on a background
thread with an atomic swap).  What a search does with the tier depends on
the backend, as in the reference: ``backend="fused"`` scans each probed
list's delta sub-list in the same launch of kernel 4 / 5 as the list
(`DeltaLists`), while the staged backends (``None``, ``"host"``,
``"tiles"``, ``"pallas"``) merge an exact scan of the WHOLE tier (kernel 1,
`knn_topk`) into the base result, base candidates winning ties.  The two
give different neighbours whenever a delta row's centroid is not probed.

The tier lives on the index's device once: raw rows in append order (for
IVF-PQ inside the combined re-rank tier ``sup_all``, base rows first), PQ
codes of the residuals code-major, and the CSR grouping by centroid.  The
buffers have power-of-two capacities and an append copies in only its new
rows; a search takes one consistent snapshot of (base, tier) under the
index lock (`DynamicIVFIndex.fused_state`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import persist
from .. import _build
from ..knn_topk.ops import knn_topk
from . import pq as pqmod
from .ref import DeltaLists, ivf_probe, ivf_scan_plain, ivfpq_adc_plain

DEFAULT_NPROBE = 8
# ADC shortlist multiplier: at corpus scale (1e5+ rows) within-cluster score
# gaps shrink while quantization error does not, so the shortlist needs
# headroom (the reference's default)
DEFAULT_RERANK = 8
#: delta rows tolerated before ``maybe_recluster`` compacts the index (the
#: reference's default)
DEFAULT_DELTA_CAP = 4096
# default list-length rounding; the kernels take any L that is a multiple
# of it, and changing it changes the index bytes
_LANE_PAD = 8
#: the reference's execution backends: alternative routes to one function.
#: The port accepts them so callers and spec strings parse; a CUDA tensor
#: always takes the kernel and a CPU tensor its plain version.
BACKENDS = (None, "fused", "host", "tiles", "pallas")

LUT_MAX_BYTES = 200 * 1024       # pq_kernel.cu: LUT_MAX_BYTES
_GRID_YZ_MAX = 65535
#: kernel 5's fused path (pq_kernel.cu): clusters of 8 blocks a query,
#: kk <= FUSED_KMAX, a block's shared memory within FUSED_SMEM_MAX
FUSED_CLUSTER = 8
FUSED_KMAX = 2048
FUSED_SMEM_MAX = 226 * 1024


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass(frozen=True)
class IVFIndex:
    """Immutable retrieval index over one support set: device tensors for
    the search plus the numpy host mirrors the build produced."""
    centroids: torch.Tensor    # (C, D) f32, unit-norm
    sup_cm: torch.Tensor       # (C, L, D) f32, raw rows, zero padding
    ids_cm: torch.Tensor       # (C, L) i32, -1 padding
    inv_cm: torch.Tensor       # (C, L) f32, 1/||row||, 0 padding
    n_rows: int                # valid support rows
    centroids_h: np.ndarray    # host mirrors
    sup_h: np.ndarray
    ids_h: np.ndarray
    inv_h: np.ndarray

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def list_size(self) -> int:
        return self.sup_cm.shape[1]

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def rows(self) -> np.ndarray:
        """Raw support rows in ORIGINAL row order — the inverse of the
        cluster-major scatter, float-exact copies."""
        X = np.empty((self.n_rows, self.sup_h.shape[2]), np.float32)
        X[self.ids_h[self.ids_h >= 0]] = self.sup_h[self.ids_h >= 0]
        return X


@dataclasses.dataclass(frozen=True)
class IVFPQIndex:
    """Product-quantized IVF index: the same coarse partition as `IVFIndex`,
    with packed PQ codes of cluster residuals in the hot lists, stored
    CODE-MAJOR ``(C, MB, L)`` so a kernel's neighbouring threads read
    neighbouring rows' bytes of one subspace.  The raw rows survive only as
    the flat cold tier ``sup_flat`` read by the exact re-rank."""
    centroids: torch.Tensor    # (C, D) f32, unit-norm coarse quantizer
    anchors: torch.Tensor      # (C, D) f32, raw-space list means
    codes_cm: torch.Tensor     # (C, MB, L) u8, packed PQ codes, 0 padding
    ids_cm: torch.Tensor       # (C, L) i32, -1 padding
    inv_cm: torch.Tensor       # (C, L) f32, EXACT 1/||row||, 0 padding
    codebooks: torch.Tensor    # (m, 2^nbits, D/m) f32
    sup_flat: torch.Tensor     # (N, D) f32 raw rows, original order (cold)
    n_rows: int
    m: int                     # subspaces actually used (divides D)
    nbits: int                 # 4 or 8
    centroids_h: np.ndarray    # host mirrors
    codes_h: np.ndarray
    ids_h: np.ndarray
    inv_h: np.ndarray
    anchors_h: np.ndarray
    codebooks_h: np.ndarray
    sup_flat_h: np.ndarray

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def list_size(self) -> int:
        return self.codes_cm.shape[2]

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def rows(self) -> np.ndarray:
        """Raw support rows in ORIGINAL row order (the cold tier)."""
        return self.sup_flat_h

    @functools.cached_property
    def inv_flat(self) -> torch.Tensor:
        """Exact stored inverse row norms in ORIGINAL row order (N,): the
        re-rank multiplies by these instead of re-reducing the gathered
        rows, float-identical to the per-list ``inv_cm`` entries."""
        inv = np.zeros(self.n_rows, np.float32)
        inv[self.ids_h[self.ids_h >= 0]] = self.inv_h[self.ids_h >= 0]
        return _dev(inv, self.device)


def default_n_clusters(n_rows: int) -> int:
    """~sqrt(N) lists — the classical IVF balance point where probe cost
    (nprobe * N/C) and quantizer cost (C) meet."""
    return int(np.clip(round(math.sqrt(max(n_rows, 1))), 1, 4096))


def _spherical_kmeans(xn: np.ndarray, n_clusters: int, seed: int,
                      iters: int) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd iterations on unit-norm rows with cosine assignment.  Empty
    clusters are reseeded from the rows worst-served by their centroid."""
    rng = np.random.default_rng(seed)
    n = len(xn)
    cent = xn[rng.choice(n, size=n_clusters, replace=False)].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        cs = xn @ cent.T                        # (N, C)
        assign = np.argmax(cs, axis=1)
        best = cs[np.arange(n), assign]
        worst = np.argsort(best, kind="stable") # rows worst-served first
        # each cluster's members as one slice of the rows sorted stably by
        # cluster: the rows `xn[assign == c]` selects, in the same order, so
        # the same means bit for bit, without a mask over all rows a cluster
        xs = xn[np.argsort(assign, kind="stable")]
        ends = np.cumsum(np.bincount(assign, minlength=n_clusters))
        w = 0
        for c in range(n_clusters):
            s0 = ends[c - 1] if c else 0
            if ends[c] == s0:
                # reseed each empty cluster from a DISTINCT worst-served row
                # (a shared reseed row would keep the duplicates collapsed)
                cent[c] = xn[worst[w]]
                w += 1
                continue
            m = xs[s0:ends[c]].mean(axis=0)
            cent[c] = m / max(float(np.linalg.norm(m)), 1e-12)
    assign = np.argmax(xn @ cent.T, axis=1)
    return cent.astype(np.float32), assign


def _top_pc(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Top principal direction of x's rows (3 power iterations)."""
    xc = x - x.mean(axis=0)
    v = rng.normal(size=x.shape[1]).astype(np.float32)
    for _ in range(3):
        v = xc.T @ (xc @ v)
        v /= max(float(np.linalg.norm(v)), 1e-12)
    return v


def _halve_by_top_pc(x: np.ndarray, rows: np.ndarray,
                     rng: np.random.Generator):
    """Split rows into two equal halves by the median projection onto the
    members' top principal direction."""
    order = np.argsort(x @ _top_pc(x, rng), kind="stable")
    half = len(rows) // 2
    return rows[order[:half]], rows[order[half:]]


def _balanced_lists(xn: np.ndarray, assign: np.ndarray, n_clusters: int,
                    cap: int, seed: int):
    """Cluster member lists with every list <= cap rows: oversized k-means
    cells are recursively halved along their top principal direction."""
    rng = np.random.default_rng(seed + 1)
    queue = [np.flatnonzero(assign == c) for c in range(n_clusters)]
    queue = [r for r in queue if len(r)]
    lists = []
    while queue:
        rows = queue.pop()
        if len(rows) <= cap:
            lists.append(rows)
        else:
            queue.extend(_halve_by_top_pc(xn[rows], rows, rng))
    return lists


def _coarse_partition(sup: np.ndarray, n_clusters: int | None, seed: int,
                      iters: int, balance: float, lane_pad: int):
    """Shared front half of both index builders: spherical k-means +
    principal-direction balancing/relabelling.  Returns (centroids (C, D)
    unit-norm, member-row lists ordered along the centroids' top principal
    direction, padded list length, per-row norms (N, 1))."""
    n, d = sup.shape
    c = min(n_clusters or default_n_clusters(n), n)
    norms = np.maximum(np.linalg.norm(sup, axis=1, keepdims=True), 1e-12)
    xn = sup / norms
    cent, assign = _spherical_kmeans(xn, c, seed, iters)

    cap = max(lane_pad, int(math.ceil(balance * n / c)))
    lists = _balanced_lists(xn, assign, c, cap, seed)
    c = len(lists)
    # relabel clusters along their top principal direction: cluster ids are
    # otherwise arbitrary, and the reference's query sort relies on nearby
    # ids meaning nearby clusters
    cents0 = np.stack([xn[r].mean(axis=0) for r in lists])
    rngv = np.random.default_rng(seed + 2)
    perm = np.argsort(cents0 @ _top_pc(cents0, rngv), kind="stable")
    lists = [lists[i] for i in perm]
    cents0 = cents0[perm]
    lsz = int(np.ceil(max(max(len(r) for r in lists), 1)
                      / lane_pad) * lane_pad)
    centroids = np.zeros((c, d), np.float32)
    for ci in range(c):
        centroids[ci] = cents0[ci] / max(float(np.linalg.norm(cents0[ci])),
                                         1e-12)
    return centroids, lists, lsz, norms


def assemble_ivf(centroids: np.ndarray, sup_cm: np.ndarray,
                 ids_cm: np.ndarray, inv_cm: np.ndarray, n_rows: int,
                 device="cuda") -> IVFIndex:
    """Wrap the serializable arrays into an `IVFIndex` on ``device``
    (shared by the builder and the artifact loader)."""
    return IVFIndex(_dev(centroids, device), _dev(sup_cm, device),
                    _dev(ids_cm, device), _dev(inv_cm, device), int(n_rows),
                    centroids, sup_cm, ids_cm, inv_cm)


def build_ivf_index(support, n_clusters: int | None = None, seed: int = 0,
                    iters: int = 10, balance: float = 1.5,
                    lane_pad: int = _LANE_PAD, device="cuda") -> IVFIndex:
    """support (N, D) raw rows (normalized internally for clustering only —
    scoring keeps the raw rows).  ``n_clusters`` is a TARGET: oversized
    k-means cells are split until no list exceeds ``balance *
    N/n_clusters`` rows, so the final count can be higher.  ``lane_pad``
    rounds the padded list length (and floors the balance cap)."""
    sup = np.asarray(support, np.float32)
    n, d = sup.shape
    centroids, lists, lsz, norms = _coarse_partition(
        sup, n_clusters, seed, iters, balance, lane_pad)
    c = len(lists)
    sup_cm = np.zeros((c, lsz, d), np.float32)
    ids_cm = np.full((c, lsz), -1, np.int32)
    inv_cm = np.zeros((c, lsz), np.float32)
    for ci, rows in enumerate(lists):
        sup_cm[ci, :len(rows)] = sup[rows]
        ids_cm[ci, :len(rows)] = rows
        inv_cm[ci, :len(rows)] = 1.0 / norms[rows, 0]
    return assemble_ivf(centroids, sup_cm, ids_cm, inv_cm, n, device)


def assemble_ivfpq(centroids: np.ndarray, anchors: np.ndarray,
                   codes_cm: np.ndarray, ids_cm: np.ndarray,
                   inv_cm: np.ndarray, codebooks: np.ndarray,
                   sup_flat: np.ndarray, n_rows: int, m: int, nbits: int,
                   device="cuda") -> IVFPQIndex:
    """Wrap the serializable arrays into an `IVFPQIndex` on ``device``.
    ``codes_cm`` arrives CODE-MAJOR ``(C, MB, L)``.  Shared by the builder
    and the artifact loader, so a reloaded index equals a fresh build."""
    return IVFPQIndex(
        _dev(centroids, device), _dev(anchors, device), _dev(codes_cm, device),
        _dev(ids_cm, device), _dev(inv_cm, device), _dev(codebooks, device),
        _dev(sup_flat, device), int(n_rows), int(m), int(nbits),
        centroids, codes_cm, ids_cm, inv_cm, anchors, codebooks, sup_flat)


def build_ivfpq_index(support, n_clusters: int | None = None,
                      m: int | None = None, nbits: int = 8, seed: int = 0,
                      iters: int = 10, balance: float = 1.5,
                      lane_pad: int = _LANE_PAD, pq_iters: int = 8,
                      device="cuda") -> IVFPQIndex:
    """IVF-PQ index build: the identical coarse partition as
    `build_ivf_index`, then per-list raw-space anchors, residual PQ
    codebooks (`pq.train_pq`), and packed per-row codes.  ``m`` defaults to
    ~D/8 and is clamped to the largest divisor of D; ``nbits`` is 8 (one
    byte per code) or 4 (two codes per byte, m must stay even)."""
    sup = np.asarray(support, np.float32)
    n, d = sup.shape
    m = pqmod.default_m(d) if m is None else pqmod.effective_m(d, m)
    if nbits == 4 and m % 2:
        m = max(2, m - 1)
        m = pqmod.effective_m(d, m)
        if m % 2:
            raise ValueError(f"nbits=4 needs an even subspace count; no even "
                             f"divisor of D={d} near the requested m")
    centroids, lists, lsz, norms = _coarse_partition(
        sup, n_clusters, seed, iters, balance, lane_pad)
    c = len(lists)

    anchors = np.zeros((c, d), np.float32)
    for ci, rows in enumerate(lists):
        anchors[ci] = sup[rows].mean(axis=0)
    order = np.concatenate(lists)
    owner = np.repeat(np.arange(c), [len(r) for r in lists])
    residuals = sup[order] - anchors[owner]
    codebooks = pqmod.train_pq(residuals, m, nbits, seed=seed + 3,
                               iters=pq_iters)
    codes_all = pqmod.pack_codes(pqmod.encode_pq(residuals, codebooks), nbits)

    mb = codes_all.shape[1]
    # code-major hot lists: (C, MB, L)
    codes_cm = np.zeros((c, mb, lsz), np.uint8)
    ids_cm = np.full((c, lsz), -1, np.int32)
    inv_cm = np.zeros((c, lsz), np.float32)
    at = 0
    for ci, rows in enumerate(lists):
        codes_cm[ci, :, :len(rows)] = codes_all[at:at + len(rows)].T
        ids_cm[ci, :len(rows)] = rows
        inv_cm[ci, :len(rows)] = 1.0 / norms[rows, 0]
        at += len(rows)
    return assemble_ivfpq(centroids, anchors, codes_cm, ids_cm, inv_cm,
                          codebooks, sup, n, m, nbits, device)


def _pow2_pad(n: int, floor: int = 8) -> int:
    """Next power of two >= max(n, floor): the reference's capacity
    schedule of the streaming tier (its padded sub-list length ``Lc``);
    here also the capacity of the tier's device buffers."""
    return max(floor, 1 << max(0, int(math.ceil(math.log2(max(n, 1))))))


@dataclasses.dataclass(frozen=True)
class TierSnapshot:
    """One consistent view of a `DynamicIVFIndex` for one search: the base,
    the delta tier (None when empty), the rows the two serve, the
    reference's padded sub-list length ``lc`` (``k`` / ``kk`` clamps only)
    and, over an IVF-PQ base with a tier, the combined re-rank tier (base
    rows, then delta rows at their global ids)."""
    base: object
    delta: Optional[DeltaLists]
    n_rows: int
    lc: int
    sup_all: Optional[torch.Tensor] = None
    inv_all: Optional[torch.Tensor] = None


class DynamicIVFIndex:
    """Streaming wrapper over a frozen `IVFIndex` / `IVFPQIndex` (the port
    of `repro.kernels.knn_ivf.ops.DynamicIVFIndex`, same host state and
    semantics).

    ``append`` assigns each new row to its nearest coarse centroid (the
    numpy argmax of the reference, so ``delta_assign`` has its bytes) and
    stores it in the delta tier; delta row ``j`` carries the global id
    ``base.n_rows + j``, stable across any later re-cluster.
    ``recluster()`` rebuilds the base over ``all_rows()`` with the original
    build parameters — by seed determinism bitwise equal to a fresh build
    over the same rows (the numpy build is the reference's, so equal to its
    bytes too) — and clears the tier.  ``maybe_recluster`` compacts once
    the tier exceeds ``delta_cap``; ``sync=False`` builds on a daemon
    thread and swaps under the lock, so routes never wait on k-means.

    Every mutation and the snapshot a search takes run under one
    ``threading.RLock``; the ``on_recluster`` hook runs after a swap,
    outside the lock, on whichever thread compacted."""

    def __init__(self, base, delta_cap: int = DEFAULT_DELTA_CAP,
                 build_kw: dict | None = None):
        if not isinstance(base, (IVFIndex, IVFPQIndex)):
            raise TypeError(f"DynamicIVFIndex wraps an IVFIndex or "
                            f"IVFPQIndex, got {type(base).__name__}")
        if delta_cap < 1:
            raise ValueError(f"delta_cap must be >= 1, got {delta_cap}")
        self.base = base
        d = int(base.centroids_h.shape[1])
        self.delta_x = np.zeros((0, d), np.float32)
        self.delta_assign = np.zeros((0,), np.int32)
        self.delta_cap = int(delta_cap)
        self.build_kw = dict(build_kw or {})
        self.appends = 0       # rows appended over the index lifetime
        self.reclusters = 0    # compactions run
        self._lock = threading.RLock()
        self._rc_thread: threading.Thread | None = None
        #: the tier's device buffers (grown by copies of new rows) and the
        #: snapshot searches read; rebuilt under the lock at every mutation
        self._buf = None
        self._snap = TierSnapshot(base, None, base.n_rows, 0)
        #: mutation hook: called (no args, OUTSIDE the lock, on whichever
        #: thread ran the compaction) after every re-cluster swap; it may
        #: only set a flag or enqueue work for another thread
        self.on_recluster = None

    # ---- delegated shape/meta (read under the lock: a swap replaces the
    # base and the tier together) ----
    @property
    def is_pq(self) -> bool:
        with self._lock:
            return isinstance(self.base, IVFPQIndex)

    @property
    def dim(self) -> int:
        with self._lock:
            return int(self.base.centroids_h.shape[1])

    @property
    def delta_rows(self) -> int:
        with self._lock:
            return len(self.delta_x)

    @property
    def n_rows(self) -> int:
        with self._lock:
            return self.base.n_rows + len(self.delta_x)

    @property
    def n_clusters(self) -> int:
        with self._lock:
            return self.base.n_clusters

    @property
    def list_size(self) -> int:
        with self._lock:
            return self.base.list_size

    @property
    def device(self) -> torch.device:
        with self._lock:
            return self.base.device

    @property
    def delta_device_bytes(self) -> int:
        """Device bytes of the tier's buffers (rows, norms, codes and the
        CSR grouping; the base prefix of IVF-PQ's ``sup_all`` excluded)."""
        with self._lock:
            buf, snap = self._buf, self._snap
            if buf is None or snap.delta is None:
                return 0
            d = snap.delta
            off0 = buf["off0"]
            n = (buf["flat"].numel() - off0 * buf["flat"].shape[1]) * 4 \
                + (buf["inv"].numel() - off0) * 4
            if buf["codes"] is not None:
                n += buf["codes"].numel()
            return int(n + d.off.numel() * 4 + d.perm.numel() * 4)

    def fused_state(self) -> TierSnapshot:
        """The (base, tier) pair a search reads, taken under the lock, in
        the port's layout (`TierSnapshot`, `DeltaLists`): the reference's
        padded ``(C, Lc)`` sub-lists become CSR over rows kept once.  Built
        at each mutation, not lazily, and read by every backend."""
        with self._lock:
            return self._snap

    # ---- streaming append ----
    def append(self, rows) -> np.ndarray:
        """Add rows (n, D) to the delta tier.  Returns their global row ids
        (stable across any later re-cluster).  The device tier grows by
        copies of these rows only."""
        rows = np.atleast_2d(np.asarray(rows, np.float32))
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"append expects rows of shape (n, {self.dim}), "
                             f"got {rows.shape}")
        rn = rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True),
                               1e-12)
        with self._lock:
            cents = self.base.centroids_h
            assign = np.argmax(rn @ cents.T, axis=1).astype(np.int32)
            ids = (self.base.n_rows + len(self.delta_x)
                   + np.arange(len(rows), dtype=np.int32))
            self.delta_x = np.concatenate([self.delta_x, rows])
            # kill-injection barrier: dying between the two delta mutations
            # leaves torn in-memory state only; recovery replays the batch
            # from the WAL record fsync'd before this append was entered
            persist.maybe_kill("index-mid-append")
            self.delta_assign = np.concatenate([self.delta_assign, assign])
            self.appends += len(rows)
            self._refresh()
        return ids

    def _refresh(self) -> None:
        """Bring the device tier up to the host tier and publish a new
        snapshot (under the lock).  Buffers keep power-of-two capacities;
        only rows not yet on the device are copied in (and, over a PQ base,
        coded against their centroid's anchor with the base codebooks).  A
        new base, or a tier past capacity, takes new buffers: a snapshot
        still in use keeps the old ones, and rows it reads are never
        rewritten."""
        with self._lock:      # re-entrant: every caller holds it already
            base = self.base
            nd = len(self.delta_x)
            if not nd:
                self._buf = None
                self._snap = TierSnapshot(base, None, base.n_rows, 0)
                return
            dev = base.device
            pq = isinstance(base, IVFPQIndex)
            d = self.delta_x.shape[1]
            off0 = base.n_rows if pq else 0     # IVF-PQ: inside sup_all
            buf = self._buf
            if buf is None or buf["base"] is not base or buf["cap"] < nd:
                cap = _pow2_pad(nd)
                new = {"base": base, "cap": cap, "off0": off0, "n": 0,
                       "flat": torch.empty((off0 + cap, d),
                                           dtype=torch.float32, device=dev),
                       "inv": torch.empty((off0 + cap,), dtype=torch.float32,
                                          device=dev),
                       "codes": torch.empty((base.codes_cm.shape[1], cap),
                                            dtype=torch.uint8, device=dev)
                       if pq else None}
                if buf is not None and buf["base"] is base:
                    n = buf["n"]
                    new["flat"][:off0 + n] = buf["flat"][:off0 + n]
                    new["inv"][:off0 + n] = buf["inv"][:off0 + n]
                    if pq:
                        new["codes"][:, :n] = buf["codes"][:, :n]
                    new["n"] = n
                elif pq:
                    new["flat"][:off0] = base.sup_flat
                    new["inv"][:off0] = base.inv_flat
                buf = self._buf = new
            lo = buf["n"]
            if lo < nd:
                x = self.delta_x[lo:nd]
                inv = (1.0 / np.maximum(np.linalg.norm(x, axis=1),
                                        1e-12)).astype(np.float32)
                buf["flat"][off0 + lo:off0 + nd] = torch.from_numpy(x).to(dev)
                buf["inv"][off0 + lo:off0 + nd] = torch.from_numpy(inv).to(dev)
                if pq:
                    res = x - base.anchors_h[self.delta_assign[lo:nd]]
                    codes = pqmod.pack_codes(
                        pqmod.encode_pq(res, base.codebooks_h), base.nbits)
                    buf["codes"][:, lo:nd] = torch.from_numpy(
                        np.ascontiguousarray(codes.T)).to(dev)
                buf["n"] = nd
            counts = np.bincount(self.delta_assign, minlength=base.n_clusters)
            off = np.zeros(base.n_clusters + 1, np.int32)
            off[1:] = np.cumsum(counts)
            perm = np.argsort(self.delta_assign,
                              kind="stable").astype(np.int32)
            lmax = int(counts.max())
            delta = DeltaLists(
                rows=buf["flat"][off0:off0 + nd],
                inv=buf["inv"][off0:off0 + nd],
                codes=buf["codes"][:, :nd] if pq else None, off=_dev(off, dev),
                perm=_dev(perm, dev), n_base=base.n_rows, lmax=lmax)
            self._snap = TierSnapshot(
                base, delta, base.n_rows + nd, _pow2_pad(lmax),
                buf["flat"][:off0 + nd] if pq else None,
                buf["inv"][:off0 + nd] if pq else None)

    def delta_occupancy(self) -> np.ndarray:
        """Per-centroid delta-row counts (C,): the drift diagnostic."""
        with self._lock:
            return np.bincount(self.delta_assign, minlength=self.n_clusters)

    # ---- compaction ----
    @property
    def needs_recluster(self) -> bool:
        with self._lock:
            return len(self.delta_x) > self.delta_cap

    @property
    def recluster_pending(self) -> bool:
        """A background compaction is currently building."""
        t = self._rc_thread
        return t is not None and t.is_alive()

    def join_recluster(self) -> None:
        """Wait for a pending background compaction to swap in (no-op when
        none is running).  Each caller joins the thread it observed, and
        only a caller that still sees that thread clears the slot."""
        t = self._rc_thread
        if t is not None:
            t.join()
            with self._lock:
                if self._rc_thread is t:
                    self._rc_thread = None

    def maybe_recluster(self, sync: bool = True) -> bool:
        """Compact iff the tier exceeds ``delta_cap``; returns whether a
        compaction ran (or, with ``sync=False``, was started)."""
        if self.needs_recluster and not self.recluster_pending:
            self.recluster(sync=sync)
            return True
        return False

    def all_rows(self) -> np.ndarray:
        """Every row the index serves, global-id order (base then delta)."""
        with self._lock:
            if not len(self.delta_x):
                return self.base.rows()
            return np.concatenate([self.base.rows(), self.delta_x])

    def _build_base(self, rows):
        """From-scratch build over ``rows`` with the ORIGINAL parameters, on
        the base's device (outside the lock: the slow k-means path)."""
        with self._lock:
            base = self.base
        kw = self.build_kw
        if isinstance(base, IVFPQIndex):
            return build_ivfpq_index(
                rows, n_clusters=kw.get("n_clusters"),
                m=kw.get("m", base.m), nbits=kw.get("nbits", base.nbits),
                seed=kw.get("seed", 0), lane_pad=kw.get("lane_pad", _LANE_PAD),
                device=base.device)
        return build_ivf_index(
            rows, n_clusters=kw.get("n_clusters"), seed=kw.get("seed", 0),
            lane_pad=kw.get("lane_pad", _LANE_PAD), device=base.device)

    def recluster(self, sync: bool = True) -> None:
        """Re-train the coarse partition (and PQ codebooks) over base +
        delta rows with the original build parameters, then clear the tier.
        ``sync=False`` runs the rebuild on a daemon thread and swaps the
        compacted base in atomically: searches keep reading the old base
        and tier meanwhile, and rows appended during the build stay in the
        tier (re-assigned to the new centroids at the swap)."""
        if not sync:
            with self._lock:
                if self.recluster_pending:
                    return
                t = threading.Thread(target=self._recluster_job, daemon=True,
                                     name="repro-torch-ivf-recluster")
                t.start()
                self._rc_thread = t
            return
        self.join_recluster()
        self._recluster_job()

    def _recluster_job(self) -> None:
        """Snapshot -> build (outside the lock) -> upload finished -> atomic
        swap.  Grad mode is per thread, so the job runs under no_grad."""
        with torch.no_grad():
            with self._lock:
                rows = self.all_rows()
                n_delta_snap = len(self.delta_x)
            new_base = self._build_base(rows)
            if new_base.device.type == "cuda":
                # the new base is whole on the card before any route sees it
                torch.cuda.current_stream(new_base.device).synchronize()
            # kill-injection barrier: a SIGKILL between build and swap loses
            # the rebuilt base but no data; recovery replays the WAL
            persist.maybe_kill("recluster-pre-swap")
            with self._lock:
                tail = self.delta_x[n_delta_snap:]      # appended mid-build
                self.base = new_base
                if len(tail):
                    tn = tail / np.maximum(
                        np.linalg.norm(tail, axis=1, keepdims=True), 1e-12)
                    self.delta_assign = np.argmax(
                        tn @ new_base.centroids_h.T, axis=1).astype(np.int32)
                    self.delta_x = tail
                else:
                    self.delta_x = np.zeros((0, self.dim), np.float32)
                    self.delta_assign = np.zeros((0,), np.int32)
                self.reclusters += 1
                self._refresh()
        cb = self.on_recluster
        if cb is not None:
            cb()          # outside the lock: the hook only flags work

    # ---- delta-tier scan + merge (staged backends) ----
    def delta_topk(self, queries, k: int):
        """Exact cosine top-k of the whole delta tier (kernel 1 over the
        device rows, which normalizes them inside): ids global, -inf / -1
        beyond the valid candidates, as the reference's numpy scan."""
        snap = self.fused_state()
        return _delta_topk(_queries(queries, snap.base), k, snap)

    def merge_delta(self, queries, base_sc, base_ix, k: int):
        """Merge a base top-k with the tier's exact scan, base candidates
        winning ties; an empty tier passes the base result through."""
        snap = self.fused_state()
        return _merge_delta(_queries(queries, snap.base), base_sc, base_ix,
                            k, snap)


def _delta_topk(q, k: int, snap: TierSnapshot):
    d = snap.delta
    qn = q.shape[0]
    sc = torch.full((qn, k), float("-inf"), dtype=torch.float32,
                    device=q.device)
    ix = torch.full((qn, k), -1, dtype=torch.int32, device=q.device)
    kk = min(k, 0 if d is None else d.rows.shape[0])
    if kk == 0:
        return sc, ix
    s, i = knn_topk(q, d.rows, kk)
    sc[:, :kk] = s
    ix[:, :kk] = torch.where(i >= 0, i + d.n_base, torch.full_like(i, -1))
    return sc, ix


def _merge_delta(q, base_sc, base_ix, k: int, snap: TierSnapshot):
    """The staged backends' merge: a stable descending sort over the base's
    top-k followed by the tier's, so base candidates win ties (the
    reference merges on the host, outside any kernel, the same way)."""
    if snap.delta is None:
        return base_sc, base_ix
    k = min(k, snap.n_rows)
    bs, bi = base_sc, base_ix
    if bs.shape[1] < k:           # base clamped below k: pad to merge width
        pad = k - bs.shape[1]
        bs = torch.cat([bs, bs.new_full((bs.shape[0], pad), float("-inf"))],
                       1)
        bi = torch.cat([bi, bi.new_full((bi.shape[0], pad), -1)], 1)
    ds, di = _delta_topk(q, k, snap)
    sc = torch.cat([bs[:, :k], ds], 1)
    ix = torch.cat([bi[:, :k], di], 1)
    order = torch.sort(sc, dim=1, descending=True, stable=True).indices[:, :k]
    out_sc = torch.gather(sc, 1, order)
    out_ix = torch.gather(ix, 1, order)
    out_ix = torch.where(torch.isfinite(out_sc), out_ix,
                         torch.full_like(out_ix, -1))
    return out_sc, out_ix


# ---------------------------------------------------------------------------
# kernel wrappers: checks, launch counter, output contract
# ---------------------------------------------------------------------------

def _fn(kernel: str, symbol: str, argtypes):
    fn = getattr(_build.load(kernel), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _check_common(name, queries, q_probe, k, tensors):
    """Checks shared by both wrappers.  True when the inputs lie on the
    CPU (the plain version runs); a CUDA input must fit the kernel."""
    if queries.ndim != 2 or q_probe.ndim != 2 \
            or q_probe.shape[0] != queries.shape[0]:
        raise ValueError(f"{name}: queries (Q, D) and q_probe (Q, P) "
                         f"expected, got {tuple(queries.shape)} and "
                         f"{tuple(q_probe.shape)}")
    if any(t.device != queries.device for t in (q_probe, *tensors)):
        raise ValueError(f"{name}: all inputs must lie on one device")
    if k < 1:
        raise ValueError(f"{name} needs k >= 1, got k={k}")
    dev = queries.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {queries.device}")
    if dev == "cuda":
        if queries.dtype != torch.float32 or q_probe.dtype != torch.int32:
            raise TypeError(f"{name}: f32 queries and int32 q_probe "
                            f"expected, got {queries.dtype}, "
                            f"{q_probe.dtype}")
        if not all(t.is_contiguous() for t in (queries, q_probe, *tensors)):
            raise ValueError(f"{name}: inputs must be contiguous")
        if max(queries.shape[0], q_probe.shape[1]) > _GRID_YZ_MAX:
            raise ValueError(f"{name}: Q and P must be <= {_GRID_YZ_MAX} "
                             f"(grid axes)")
    return dev == "cpu"


def _outputs(Q, k, n, device):
    return (torch.empty((Q, k), dtype=torch.float32, device=device),
            torch.empty((Q, k), dtype=torch.int32, device=device),
            torch.empty((Q, n), dtype=torch.int64, device=device))


def _check_delta(name, delta, queries, C, codes: bool):
    """Checks of a `DeltaLists` for a CUDA call."""
    t = (delta.rows, delta.inv, delta.off, delta.perm) + (
        (delta.codes,) if codes else ())
    if any(x.device != queries.device for x in t):
        raise ValueError(f"{name}: the delta tier must lie on the queries' "
                         f"device")
    if delta.off.shape != (C + 1,) or delta.off.dtype != torch.int32 \
            or delta.perm.dtype != torch.int32 \
            or delta.inv.dtype != torch.float32 \
            or not all(x.is_contiguous() for x in (delta.inv, delta.off,
                                                    delta.perm)):
        raise ValueError(f"{name}: delta off (C + 1,) int32, perm int32 and "
                         f"inv f32, contiguous, expected")
    if codes:
        if delta.codes.dtype != torch.uint8 or delta.codes.stride(1) != 1:
            raise ValueError(f"{name}: delta codes (MB, >= nd) uint8 with "
                             f"unit column stride expected")
    elif delta.rows.dtype != torch.float32 or not delta.rows.is_contiguous():
        raise ValueError(f"{name}: delta rows (nd, D) f32 contiguous "
                         f"expected")


def check_block_q(block_q) -> Optional[int]:
    """``block_q`` as kernel 4's query tile (None stays None: the batch's
    rule, `block_q_for`); a value with no instantiation in `kernel.cu`
    raises rather than falling back."""
    if block_q is None:
        return None
    if isinstance(block_q, bool) or int(block_q) != block_q \
            or int(block_q) not in IVF_BLOCK_QS:
        raise ValueError(f"block_q must be one of {IVF_BLOCK_QS} (kernel 4's "
                         f"instantiated query tiles), got {block_q!r}")
    return int(block_q)


def block_q_for(Q: int) -> int:
    """Kernel 4's query tile for a batch of ``Q`` queries when none is
    asked for: 64 from Q 64 (fewer reads of the lists its queries share:
    0.77x of QT 16's time at Q 64, and faster on both delta tiers there),
    16 below (best or within noise of the best at Q 1-17)."""
    return 64 if Q >= 64 else DEFAULT_BLOCK_Q


def ivf_scan(queries, q_probe, sup_cm, ids_cm, inv_cm, k: int,
             delta: Optional[DeltaLists] = None, block_q: int | None = None):
    """Kernel 4 (`kernel.cu`, the ``ivf_topk`` kernel): queries (Q, D) f32
    L2-normalized; q_probe (Q, P) int32 probed list ids; sup_cm (C, L, D)
    f32; ids_cm (C, L) int32; inv_cm (C, L) f32.  Returns (scores (Q, k)
    f32 descending, ids (Q, k) int32), -inf / -1 in slots no valid row of
    the probed lists fills (k may exceed P * L).  ``delta`` (a streaming
    index's tier) adds each probed slot's delta sub-list to its candidates,
    in the same launch.  On the GPU, k <= 2,048 is one CUDA launch: each
    probed list (and sub-list) is read once per tile of ``block_q``
    queries (8, 16, 32 or 64; None: `block_q_for` Q), and selector blocks
    of the same launch select each query once its ticket counts all its
    keys.  Every tile gives the same bits; the plain version ignores it."""
    qt = check_block_q(block_q)
    if sup_cm.ndim != 3 or sup_cm.shape[2] != queries.shape[-1] \
            or ids_cm.shape != sup_cm.shape[:2] \
            or inv_cm.shape != sup_cm.shape[:2]:
        raise ValueError(f"ivf_scan: sup_cm (C, L, D), ids_cm / inv_cm (C, L)"
                         f" expected, got {tuple(sup_cm.shape)}, "
                         f"{tuple(ids_cm.shape)}, {tuple(inv_cm.shape)}")
    if _check_common("ivf_scan", queries, q_probe, k,
                     (sup_cm, ids_cm, inv_cm)):
        return ivf_scan_plain(queries, q_probe, sup_cm, ids_cm, inv_cm, k,
                              delta)
    if (sup_cm.dtype, ids_cm.dtype, inv_cm.dtype) != (
            torch.float32, torch.int32, torch.float32):
        raise TypeError("ivf_scan: f32 sup_cm, int32 ids_cm and f32 inv_cm "
                        "expected")
    Q, D = queries.shape
    P = q_probe.shape[1]
    C, L, _ = sup_cm.shape
    dmax = 0
    if delta is not None and delta.lmax:
        _check_delta("ivf_scan", delta, queries, C, codes=False)
        dmax = int(delta.lmax)
    if P * (L + dmax) > _INT_MAX:
        raise ValueError(f"ivf_scan: P * (L + lmax) = {P * (L + dmax)} "
                         f"candidates a query is too many for one call")
    out_s, out_i, keys = _outputs(Q, k, P * (L + dmax), queries.device)
    if Q == 0:
        return out_s, out_i
    if qt is None:
        qt = block_q_for(Q)
    fn = _fn("ivf_topk", "ivf_topk_launch",
             [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    count = _fn("ivf_topk", "ivf_topk_device_launches", [])
    count.restype = ctypes.c_ulonglong
    ticket = _ticket(queries.device, Q)
    dptr = ((delta.rows.data_ptr(), delta.inv.data_ptr(),
             delta.off.data_ptr(), delta.perm.data_ptr()) if dmax
            else (0, 0, 0, 0))
    before = count()
    err = fn(queries.data_ptr(), q_probe.data_ptr(), sup_cm.data_ptr(),
             ids_cm.data_ptr(), inv_cm.data_ptr(), *dptr, keys.data_ptr(),
             ticket.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), Q, P, C,
             L, D, k, delta.n_base if dmax else 0, dmax, qt,
             _build.stream_ptr(queries.device))
    _build.check(err, "ivf_scan")
    ivf_scan.launches += 1
    ivf_scan.last_cuda_launches = count() - before
    ivf_scan.last_block_q = qt
    return out_s, out_i


#: calls that launched kernel 4 (one per call on a CUDA tensor)
ivf_scan.launches = 0
#: CUDA kernels the last CUDA call launched (the kernel library's own
#: count: 1 for k <= 2,048; above it the scan and ceil(k / 1,024) rounds of
#: the per-query selection)
ivf_scan.last_cuda_launches = 0
#: the query tile of the last CUDA call (None before one)
ivf_scan.last_block_q = None
#: k of kernel 4's one-launch path (kernel.cu: FK_MAX)
IVF_ONE_LAUNCH_KMAX = 2048
#: kernel 4's query tiles instantiated in kernel.cu (the reference's
#: ``block_q`` candidates) and the tile below Q 64 (`block_q_for`)
IVF_BLOCK_QS = (8, 16, 32, 64)
DEFAULT_BLOCK_Q = 16
_INT_MAX = 2**31 - 1

#: kernel 4's ticket counters, by (device, stream): one per query, allocated
#: with zeros once (grown as Q grows), left at zero by every call's
#: selector blocks
_tickets: dict = {}


def _ticket(dev: torch.device, n: int) -> torch.Tensor:
    key = (dev.index, _build.stream_ptr(dev))
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _tickets[key] = t
    return t


def _pow2_at_least(k: int) -> int:
    w = 1
    while w < k:
        w <<= 1
    return w


def fused_smem_bytes(m: int, nbits: int, MB: int, L: int, P: int,
                     kk: int, dmax: int = 0) -> int:
    """Shared memory of one block of kernel 5's fused path (pq_kernel.cu:
    `FusedSmem`): the table (which the leader reuses for its selection's
    2,048-bin histogram and sort buffer of max(256, the next power of two
    >= kk) keys, select.cuh `sel_smem`), its ceil(P / 8) lists' codes
    rounded to 16 bytes (which the leader reuses for the query's
    P x (L + dmax) keys: its lists' and, padded to the largest sub-list
    ``dmax``, their delta sub-lists'), and its lists' keys and anchor
    dots."""
    a16 = lambda x: -(-x // 16) * 16  # noqa: E731
    pb = -(-P // FUSED_CLUSTER)
    lut = a16(max(m * 2 ** nbits * 4,
                  2048 * 4 + max(_pow2_at_least(kk), 256) * 8))
    codes = a16(max(pb * a16(MB * L), P * (L + dmax) * 8))
    return lut + codes + a16(pb * L * 8 + pb * 4)


def fused_fits(m: int, nbits: int, MB: int, L: int, P: int, kk: int,
               dmax: int = 0) -> bool:
    """Whether kernel 5 takes its one-launch fused path at this shape
    (``dmax``: the largest delta sub-list, 0 without a tier); the other
    shapes (nprobe near the number of lists, kk > 2,048, a sub-list too
    long for the leader's keys) take the three launches."""
    return (kk <= FUSED_KMAX and (MB * L) % 4 == 0
            and fused_smem_bytes(m, nbits, MB, L, P, kk, dmax)
            <= FUSED_SMEM_MAX)


def ivfpq_adc(queries, q_probe, codes_cm, ids_cm, inv_cm, anchors, codebooks,
              k: int, m: int, nbits: int,
              delta: Optional[DeltaLists] = None):
    """Kernel 5 (`pq_kernel.cu`): the ADC shortlist.  queries (Q, D) f32
    L2-normalized; q_probe (Q, P) int32; codes_cm (C, MB, L) uint8
    code-major, MB = m * nbits / 8; ids_cm / inv_cm (C, L); anchors (C, D)
    f32; codebooks (m, 2^nbits, D/m) f32.  Returns (scores (Q, k), ids
    (Q, k)) with the contract of `ivf_scan`.  ``delta`` (a streaming
    index's tier, its codes coded with these codebooks against their own
    centroid's anchor) adds each probed slot's delta sub-list to the scan,
    in the same launch.  On the GPU the per-query table (m * 2^nbits * 4
    bytes) must fit in shared memory (`LUT_MAX_BYTES`); the shape picks
    the kernel's path there (`fused_fits`: one fused launch, else
    three)."""
    if nbits not in (4, 8) or codes_cm.ndim != 3 \
            or codes_cm.shape[1] * 8 != m * nbits \
            or codebooks.shape != (m, 2 ** nbits, queries.shape[-1] // m) \
            or m * codebooks.shape[2] != queries.shape[-1] \
            or ids_cm.shape != (codes_cm.shape[0], codes_cm.shape[2]) \
            or inv_cm.shape != ids_cm.shape \
            or anchors.shape != (codes_cm.shape[0], queries.shape[-1]):
        raise ValueError(
            f"ivfpq_adc: inconsistent shapes: codes_cm {tuple(codes_cm.shape)}"
            f", codebooks {tuple(codebooks.shape)}, ids_cm "
            f"{tuple(ids_cm.shape)}, anchors {tuple(anchors.shape)}, "
            f"m={m}, nbits={nbits}, D={queries.shape[-1]}")
    tensors = (codes_cm, ids_cm, inv_cm, anchors, codebooks)
    if _check_common("ivfpq_adc", queries, q_probe, k, tensors):
        return ivfpq_adc_plain(queries, q_probe, codes_cm, ids_cm, inv_cm,
                               anchors, codebooks, k, m, nbits, delta)
    if (codes_cm.dtype, ids_cm.dtype, inv_cm.dtype, anchors.dtype,
            codebooks.dtype) != (torch.uint8, torch.int32, torch.float32,
                                 torch.float32, torch.float32):
        raise TypeError("ivfpq_adc: uint8 codes, int32 ids and f32 inv, "
                        "anchors and codebooks expected")
    lut_bytes = m * 2 ** nbits * 4
    if lut_bytes > LUT_MAX_BYTES:
        raise ValueError(
            f"ivfpq_adc: the per-query ADC table (m * 2^nbits * 4 = "
            f"{lut_bytes} bytes) does not fit in a block's shared memory "
            f"(limit {LUT_MAX_BYTES}); use fewer subspaces or nbits=4")
    C, MB, L = codes_cm.shape
    dmax = delta.lmax if delta is not None else 0
    fused = fused_fits(m, nbits, MB, L, q_probe.shape[1], k, dmax)
    return _adc_cuda(queries, q_probe, codes_cm, ids_cm, inv_cm, anchors,
                     codebooks, k, m, nbits, fused, delta)


def _adc_cuda(queries, q_probe, codes_cm, ids_cm, inv_cm, anchors, codebooks,
              k: int, m: int, nbits: int, fused: bool,
              delta: Optional[DeltaLists] = None):
    """Kernel 5's CUDA launch on one path, for inputs `ivfpq_adc` has
    checked: the fused launch (only where `fused_fits`) or the three
    launches.  `ivfpq_adc` takes the shape's path; the tests call this
    directly to hold the two paths against each other at one shape."""
    Q, D = queries.shape
    P = q_probe.shape[1]
    C, MB, L = codes_cm.shape
    dmax = 0
    if delta is not None and delta.lmax:
        _check_delta("ivfpq_adc", delta, queries, C, codes=True)
        if delta.codes.shape[0] != MB:
            raise ValueError(f"ivfpq_adc: delta codes have "
                             f"{delta.codes.shape[0]} bytes a row, the lists "
                             f"{MB}")
        dmax = int(delta.lmax)
    if P * (L + dmax) > _INT_MAX:
        raise ValueError(f"ivfpq_adc: P * (L + lmax) = {P * (L + dmax)} "
                         f"candidates a query is too many for one call")
    if fused and not fused_fits(m, nbits, MB, L, P, k, dmax):
        raise ValueError(
            f"ivfpq_adc: the fused path takes kk <= {FUSED_KMAX} and at most "
            f"{FUSED_SMEM_MAX} bytes of shared memory a block; kk={k}, P={P},"
            f" L={L}, lmax={dmax} need "
            f"{fused_smem_bytes(m, nbits, MB, L, P, k, dmax)}")
    dev = queries.device
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    lut = keys = None
    if not fused:
        lut = torch.empty((Q, m * 2 ** nbits), dtype=torch.float32,
                          device=dev)
        keys = torch.empty((Q, P * (L + dmax)), dtype=torch.int64,
                           device=dev)
    fn = _fn("ivfpq_adc", "ivfpq_adc_launch",
             [ctypes.c_void_p] * 15 + [ctypes.c_int] * 13
             + [ctypes.c_void_p])
    count = _fn("ivfpq_adc", "ivfpq_adc_device_launches", [])
    count.restype = ctypes.c_ulonglong
    dptr = ((delta.codes.data_ptr(), delta.inv.data_ptr(),
             delta.off.data_ptr(), delta.perm.data_ptr()) if dmax
            else (0, 0, 0, 0))
    before = count()
    err = fn(queries.data_ptr(), q_probe.data_ptr(), codes_cm.data_ptr(),
             ids_cm.data_ptr(), inv_cm.data_ptr(), anchors.data_ptr(),
             codebooks.data_ptr(), *dptr,
             0 if lut is None else lut.data_ptr(),
             0 if keys is None else keys.data_ptr(), out_s.data_ptr(),
             out_i.data_ptr(), Q, P, C, MB, L, D, m, nbits, k, int(fused),
             delta.n_base if dmax else 0, dmax,
             delta.codes.stride(0) if dmax else 0, _build.stream_ptr(dev))
    if fused and err == _CUDA_INVALID_CONFIGURATION:
        raise RuntimeError("ivfpq_adc: cudaOccupancyMaxActiveClusters "
                           "reports no resident cluster of 8 blocks for the "
                           "fused path on this device")
    _build.check(err, "ivfpq_adc")
    ivfpq_adc.launches += 1
    ivfpq_adc.last_cuda_launches = count() - before
    return out_s, out_i


_CUDA_INVALID_CONFIGURATION = 9


def fused_plan(m: int, nbits: int, MB: int, L: int, P: int, kk: int,
               dmax: int = 0):
    """(shared memory bytes of a fused block, clusters of 8 such blocks the
    current device holds at once) from the kernel library: the occupancy
    check that refuses a fused launch at 0."""
    fn = _fn("ivfpq_adc", "ivfpq_adc_fused_plan",
             [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
    smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(fn(m, nbits, MB, L, P, kk, dmax, ctypes.byref(smem),
                    ctypes.byref(clusters)), "ivfpq_adc_fused_plan")
    return smem.value, clusters.value


#: calls that launched kernel 5 (one per call on a CUDA tensor: the fused
#: path is one CUDA launch; the three-launch path runs the table and scan
#: passes and ceil(k / 1,024) rounds of the per-query selection)
ivfpq_adc.launches = 0
#: CUDA kernels the last CUDA call launched (the kernel library's own
#: count: 1 on the fused path, 2 + ceil(k / 1,024) on the three launches)
ivfpq_adc.last_cuda_launches = 0


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def rerank_stored_inv(queries, sup_flat, inv_flat, shortlist_idx, k: int):
    """Stage 2 of the two-stage search: exact re-scoring of the ADC
    shortlist against the raw cold rows, times the STORED inverse norms (the
    reference's fused serving form; it runs outside any kernel there too).
    -1 shortlist slots stay -inf / -1."""
    safe = shortlist_idx.clamp_min(0).long()
    sims = torch.einsum("qd,qkd->qk", queries.float(), sup_flat[safe]) \
        * inv_flat[safe]
    sims = torch.where(shortlist_idx >= 0, sims,
                       torch.full_like(sims, float("-inf")))
    scores, pos = torch.topk(sims, k, dim=1)
    idx = torch.gather(shortlist_idx, 1, pos)
    idx = torch.where(torch.isfinite(scores), idx, torch.full_like(idx, -1))
    return scores, idx.to(torch.int32)


def _queries(queries, index) -> torch.Tensor:
    return torch.as_tensor(queries, dtype=torch.float32,
                           device=index.device).contiguous()


def check_backend(backend):
    """Raise unless ``backend`` names one of the reference's routes."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def ivf_topk(queries, index, k: int, nprobe: int = DEFAULT_NPROBE, *,
             backend: str | None = None, block_q: int | None = None):
    """queries (Q, D) L2-normalized.  Returns (scores (Q, k), indices
    (Q, k)) — indices into the original support row order, -inf / -1 beyond
    the valid candidates; ``k`` is clamped as in the reference.

    On a frozen `IVFIndex` every ``backend`` names the same function: the
    probe and kernel 4 (a CPU index: its plain version).  On a
    `DynamicIVFIndex` it picks the semantics, as in the reference:
    ``"fused"`` scans the probed delta sub-lists in kernel 4's launch; the
    staged backends run kernel 4 over the base and merge an exact scan of
    the whole tier (`_merge_delta`).  ``block_q`` is kernel 4's query tile
    (`ivf_scan`)."""
    check_backend(backend)
    nprobe = max(1, min(nprobe, index.n_clusters))
    if isinstance(index, DynamicIVFIndex):
        snap = index.fused_state()
        # repro: allow-unlocked: immutable snapshot taken under the lock
        base = snap.base
        q = _queries(queries, base)
        if backend != "fused":
            sc, ix = ivf_topk(q, base, k, nprobe, block_q=block_q)
            return _merge_delta(q, sc, ix, k, snap)
        k = min(k, snap.n_rows, nprobe * (base.list_size + snap.lc))
        probe = ivf_probe(q, base.centroids, nprobe)
        return ivf_scan(q, probe, base.sup_cm, base.ids_cm, base.inv_cm, k,
                        snap.delta, block_q=block_q)
    k = min(k, index.n_rows, nprobe * index.list_size)
    q = _queries(queries, index)
    probe = ivf_probe(q, index.centroids, nprobe)
    return ivf_scan(q, probe, index.sup_cm, index.ids_cm, index.inv_cm, k,
                    block_q=block_q)


def ivfpq_topk(queries, index, k: int, nprobe: int = DEFAULT_NPROBE,
               rerank: int = DEFAULT_RERANK, *, backend: str | None = None):
    """Two-stage IVF-PQ search, same output contract as `ivf_topk`.
    Stage 1 (kernel 5) scores the probed lists' packed codes by ADC into a
    shortlist of ``kk = min(max(rerank, 1) * k, n_rows, nprobe * L)``
    candidates; stage 2 (`rerank_stored_inv`) re-scores those rows exactly
    and keeps the top k.  ``rerank=0`` returns the raw ADC top-k.
    ``backend`` on a `DynamicIVFIndex` as in `ivf_topk`: ``"fused"`` scans
    the probed delta sub-lists' codes in kernel 5's launch and re-ranks
    over the combined flat tier (base rows, then delta rows); the staged
    backends merge the tier's exact scan into the base result."""
    check_backend(backend)
    nprobe = max(1, min(nprobe, index.n_clusters))
    if isinstance(index, DynamicIVFIndex):
        snap = index.fused_state()
        # repro: allow-unlocked: immutable snapshot taken under the lock
        base = snap.base
        q = _queries(queries, base)
        if backend != "fused":
            sc, ix = ivfpq_topk(q, base, k, nprobe, rerank)
            return _merge_delta(q, sc, ix, k, snap)
        if snap.delta is not None:
            return _ivfpq_search(q, base, k, nprobe, rerank, snap.n_rows,
                                 nprobe * (base.list_size + snap.lc),
                                 snap.delta, snap.sup_all, snap.inv_all)
        index = base
    return _ivfpq_search(_queries(queries, index), index, k, nprobe, rerank,
                         index.n_rows, nprobe * index.list_size)


def _ivfpq_search(q, base, k, nprobe, rerank, n, cand, delta=None,
                  sup=None, inv=None):
    k = min(k, n, cand)
    kk = min(max(rerank, 1) * k, n, cand) if rerank else 0
    probe = ivf_probe(q, base.centroids, nprobe)
    sc, ix = ivfpq_adc(q, probe, base.codes_cm, base.ids_cm, base.inv_cm,
                       base.anchors, base.codebooks, kk or k, m=base.m,
                       nbits=base.nbits, delta=delta)
    if not rerank:
        return sc, ix
    if delta is None:
        sup, inv = base.sup_flat, base.inv_flat
    return rerank_stored_inv(q, sup, inv, ix, k)
