"""IVF / IVF-PQ index build and search of the port (mirrors
`repro.kernels.knn_ivf.ops` for frozen indexes).

``build_ivf_index`` fits a spherical k-means coarse quantizer in numpy (once,
at ``KNNRouter.fit``) and lays the support set out cluster-major:
``sup_cm (C, L, D)`` raw rows zero-padded to the list length L, ``ids_cm
(C, L)`` original row ids with -1 padding, ``inv_cm (C, L)`` inverse row
norms with 0 padding.  Oversized clusters are recursively halved along
their top principal direction until every list fits ``balance * N/C`` rows.
``build_ivfpq_index`` keeps the same partition and stores packed PQ codes
of the rows' residuals code-major ``(C, MB, L)`` (`pq.py`), plus the raw
rows as the flat cold tier ``sup_flat`` that the exact re-rank reads.  The
numpy build is the reference's, unchanged, so both packages give the same
bytes from the same rows and seed.

Search: ``ivf_topk`` probes each query's ``nprobe`` nearest centroids
(`ref.ivf_probe`) and runs kernel 4 (`ivf_scan`: `kernel.cu`) over the
probed lists; ``ivfpq_topk`` runs kernel 5 (`ivfpq_adc`: `pq_kernel.cu`)
for an ADC shortlist of ``rerank * k`` candidates, then re-scores the
shortlist exactly against the cold rows with the stored inverse norms
(`rerank_stored_inv`, the reference's fused serving form) and keeps the top
k.  Each kernel wrapper runs its plain version (`ref.py`) for CPU tensors
and launches its kernel for CUDA tensors, or raises.

The streaming tier of the reference (`DynamicIVFIndex`: delta sub-lists,
re-clustering, ``partial_fit``) is not ported yet
(`StreamingIndexNotPortedError`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from .. import _build
from . import pq as pqmod
from .ref import ivf_probe, ivf_scan_plain, ivfpq_adc_plain

DEFAULT_NPROBE = 8
# ADC shortlist multiplier: at corpus scale (1e5+ rows) within-cluster score
# gaps shrink while quantization error does not, so the shortlist needs
# headroom (the reference's default)
DEFAULT_RERANK = 8
#: the reference's streaming-tier compaction threshold (constructor default)
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


class StreamingIndexNotPortedError(NotImplementedError):
    """The streaming `DynamicIVFIndex` tier (``online=True``,
    ``partial_fit``, dynamic artifacts) is not ported yet: it is queue 1,
    item 3 of ROADMAP.md."""

    def __init__(self, what: str):
        super().__init__(f"{what}: the streaming DynamicIVFIndex tier is not "
                         f"ported to repro_torch yet (ROADMAP.md, queue 1, "
                         f"item 3); serve a frozen ivf / ivfpq index instead")


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
        w = 0
        for c in range(n_clusters):
            members = assign == c
            if not members.any():
                # reseed each empty cluster from a DISTINCT worst-served row
                # (a shared reseed row would keep the duplicates collapsed)
                cent[c] = xn[worst[w]]
                w += 1
                continue
            m = xn[members].mean(axis=0)
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


def ivf_scan(queries, q_probe, sup_cm, ids_cm, inv_cm, k: int):
    """Kernel 4 (`kernel.cu`, the ``ivf_topk`` kernel): queries (Q, D) f32
    L2-normalized; q_probe (Q, P) int32 probed list ids; sup_cm (C, L, D)
    f32; ids_cm (C, L) int32; inv_cm (C, L) f32.  Returns (scores (Q, k)
    f32 descending, ids (Q, k) int32), -inf / -1 in slots no valid row of
    the probed lists fills (k may exceed P * L).  On the GPU, k <= 2,048 is
    one CUDA launch: each probed list is read once per tile of 16 queries,
    and selector blocks of the same launch select each query once its
    ticket counts all its keys."""
    if sup_cm.ndim != 3 or sup_cm.shape[2] != queries.shape[-1] \
            or ids_cm.shape != sup_cm.shape[:2] \
            or inv_cm.shape != sup_cm.shape[:2]:
        raise ValueError(f"ivf_scan: sup_cm (C, L, D), ids_cm / inv_cm (C, L)"
                         f" expected, got {tuple(sup_cm.shape)}, "
                         f"{tuple(ids_cm.shape)}, {tuple(inv_cm.shape)}")
    if _check_common("ivf_scan", queries, q_probe, k,
                     (sup_cm, ids_cm, inv_cm)):
        return ivf_scan_plain(queries, q_probe, sup_cm, ids_cm, inv_cm, k)
    if (sup_cm.dtype, ids_cm.dtype, inv_cm.dtype) != (
            torch.float32, torch.int32, torch.float32):
        raise TypeError("ivf_scan: f32 sup_cm, int32 ids_cm and f32 inv_cm "
                        "expected")
    Q, D = queries.shape
    P = q_probe.shape[1]
    C, L, _ = sup_cm.shape
    if P * L > _INT_MAX:
        raise ValueError(f"ivf_scan: P * L = {P * L} candidates a query is "
                         f"too many for one call")
    out_s, out_i, keys = _outputs(Q, k, P * L, queries.device)
    if Q == 0:
        return out_s, out_i
    fn = _fn("ivf_topk", "ivf_topk_launch",
             [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    count = _fn("ivf_topk", "ivf_topk_device_launches", [])
    count.restype = ctypes.c_ulonglong
    ticket = _ticket(queries.device, Q)
    before = count()
    err = fn(queries.data_ptr(), q_probe.data_ptr(), sup_cm.data_ptr(),
             ids_cm.data_ptr(), inv_cm.data_ptr(), keys.data_ptr(),
             ticket.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), Q, P, C,
             L, D, k, _build.stream_ptr(queries.device))
    _build.check(err, "ivf_scan")
    ivf_scan.launches += 1
    ivf_scan.last_cuda_launches = count() - before
    return out_s, out_i


#: calls that launched kernel 4 (one per call on a CUDA tensor)
ivf_scan.launches = 0
#: CUDA kernels the last CUDA call launched (the kernel library's own
#: count: 1 for k <= 2,048; above it the scan and ceil(k / 1,024) rounds of
#: the per-query selection)
ivf_scan.last_cuda_launches = 0
#: k of kernel 4's one-launch path (kernel.cu: FK_MAX)
IVF_ONE_LAUNCH_KMAX = 2048
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
                     kk: int) -> int:
    """Shared memory of one block of kernel 5's fused path (pq_kernel.cu:
    `FusedSmem`): the table (which the leader reuses for its selection's
    2,048-bin histogram and sort buffer of max(256, the next power of two
    >= kk) keys, select.cuh `sel_smem`), its ceil(P / 8) lists' codes
    rounded to 16 bytes (which the leader reuses for the query's P x L
    keys), and its lists' keys and anchor dots."""
    a16 = lambda x: -(-x // 16) * 16  # noqa: E731
    pb = -(-P // FUSED_CLUSTER)
    lut = a16(max(m * 2 ** nbits * 4,
                  2048 * 4 + max(_pow2_at_least(kk), 256) * 8))
    codes = a16(max(pb * a16(MB * L), P * L * 8))
    return lut + codes + a16(pb * L * 8 + pb * 4)


def fused_fits(m: int, nbits: int, MB: int, L: int, P: int, kk: int) -> bool:
    """Whether kernel 5 takes its one-launch fused path at this shape; the
    other shapes (nprobe near the number of lists, kk > 2,048) take the
    three launches."""
    return (kk <= FUSED_KMAX and (MB * L) % 4 == 0
            and fused_smem_bytes(m, nbits, MB, L, P, kk) <= FUSED_SMEM_MAX)


def ivfpq_adc(queries, q_probe, codes_cm, ids_cm, inv_cm, anchors, codebooks,
              k: int, m: int, nbits: int):
    """Kernel 5 (`pq_kernel.cu`): the ADC shortlist.  queries (Q, D) f32
    L2-normalized; q_probe (Q, P) int32; codes_cm (C, MB, L) uint8
    code-major, MB = m * nbits / 8; ids_cm / inv_cm (C, L); anchors (C, D)
    f32; codebooks (m, 2^nbits, D/m) f32.  Returns (scores (Q, k), ids
    (Q, k)) with the contract of `ivf_scan`.  On the GPU the per-query
    table (m * 2^nbits * 4 bytes) must fit in shared memory
    (`LUT_MAX_BYTES`); the shape picks the kernel's path there
    (`fused_fits`: one fused launch, else three)."""
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
                               anchors, codebooks, k, m, nbits)
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
    fused = fused_fits(m, nbits, MB, L, q_probe.shape[1], k)
    return _adc_cuda(queries, q_probe, codes_cm, ids_cm, inv_cm, anchors,
                     codebooks, k, m, nbits, fused)


def _adc_cuda(queries, q_probe, codes_cm, ids_cm, inv_cm, anchors, codebooks,
              k: int, m: int, nbits: int, fused: bool):
    """Kernel 5's CUDA launch on one path, for inputs `ivfpq_adc` has
    checked: the fused launch (only where `fused_fits`) or the three
    launches.  `ivfpq_adc` takes the shape's path; the tests call this
    directly to hold the two paths against each other at one shape."""
    Q, D = queries.shape
    P = q_probe.shape[1]
    C, MB, L = codes_cm.shape
    if fused and not fused_fits(m, nbits, MB, L, P, k):
        raise ValueError(
            f"ivfpq_adc: the fused path takes kk <= {FUSED_KMAX} and at most "
            f"{FUSED_SMEM_MAX} bytes of shared memory a block; kk={k}, P={P},"
            f" L={L} need {fused_smem_bytes(m, nbits, MB, L, P, k)}")
    dev = queries.device
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    lut = keys = None
    if not fused:
        lut = torch.empty((Q, m * 2 ** nbits), dtype=torch.float32,
                          device=dev)
        keys = torch.empty((Q, P * L), dtype=torch.int64, device=dev)
    fn = _fn("ivfpq_adc", "ivfpq_adc_launch",
             [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    count = _fn("ivfpq_adc", "ivfpq_adc_device_launches", [])
    count.restype = ctypes.c_ulonglong
    before = count()
    err = fn(queries.data_ptr(), q_probe.data_ptr(), codes_cm.data_ptr(),
             ids_cm.data_ptr(), inv_cm.data_ptr(), anchors.data_ptr(),
             codebooks.data_ptr(), 0 if lut is None else lut.data_ptr(),
             0 if keys is None else keys.data_ptr(), out_s.data_ptr(),
             out_i.data_ptr(), Q, P, C, MB, L, D, m, nbits, k, int(fused),
             _build.stream_ptr(dev))
    if fused and err == _CUDA_INVALID_CONFIGURATION:
        raise RuntimeError("ivfpq_adc: cudaOccupancyMaxActiveClusters "
                           "reports no resident cluster of 8 blocks for the "
                           "fused path on this device")
    _build.check(err, "ivfpq_adc")
    ivfpq_adc.launches += 1
    ivfpq_adc.last_cuda_launches = count() - before
    return out_s, out_i


_CUDA_INVALID_CONFIGURATION = 9


def fused_plan(m: int, nbits: int, MB: int, L: int, P: int, kk: int):
    """(shared memory bytes of a fused block, clusters of 8 such blocks the
    current device holds at once) from the kernel library: the occupancy
    check that refuses a fused launch at 0."""
    fn = _fn("ivfpq_adc", "ivfpq_adc_fused_plan",
             [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(fn(m, nbits, MB, L, P, kk, ctypes.byref(smem),
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


def ivf_topk(queries, index: IVFIndex, k: int,
             nprobe: int = DEFAULT_NPROBE, *, backend: str | None = None):
    """queries (Q, D) L2-normalized.  Returns (scores (Q, k), indices
    (Q, k)) — indices into the original support row order, -inf / -1 beyond
    the valid candidates; ``k`` is clamped to ``min(k, n_rows, nprobe *
    L)`` as in the reference.

    ``backend`` names one of the reference's alternative routes to this
    same function and is accepted so that its callers carry over: a CUDA
    index always runs the probe and kernel 4, a CPU index the probe and
    its plain version."""
    check_backend(backend)
    nprobe = max(1, min(nprobe, index.n_clusters))
    k = min(k, index.n_rows, nprobe * index.list_size)
    q = _queries(queries, index)
    probe = ivf_probe(q, index.centroids, nprobe)
    return ivf_scan(q, probe, index.sup_cm, index.ids_cm, index.inv_cm, k)


def ivfpq_topk(queries, index: IVFPQIndex, k: int,
               nprobe: int = DEFAULT_NPROBE, rerank: int = DEFAULT_RERANK, *,
               backend: str | None = None):
    """Two-stage IVF-PQ search, same output contract as `ivf_topk`.
    Stage 1 (kernel 5) scores the probed lists' packed codes by ADC into a
    shortlist of ``kk = min(max(rerank, 1) * k, n_rows, nprobe * L)``
    candidates; stage 2 (`rerank_stored_inv`) re-scores those rows exactly
    and keeps the top k.  ``rerank=0`` returns the raw ADC top-k.
    ``backend`` is accepted as in `ivf_topk`."""
    check_backend(backend)
    nprobe = max(1, min(nprobe, index.n_clusters))
    cand = nprobe * index.list_size
    k = min(k, index.n_rows, cand)
    kk = min(max(rerank, 1) * k, index.n_rows, cand) if rerank else 0
    q = _queries(queries, index)
    probe = ivf_probe(q, index.centroids, nprobe)
    sc, ix = ivfpq_adc(q, probe, index.codes_cm, index.ids_cm, index.inv_cm,
                       index.anchors, index.codebooks, kk or k, m=index.m,
                       nbits=index.nbits)
    if not rerank:
        return sc, ix
    return rerank_stored_inv(q, index.sup_flat, index.inv_flat, ix, k)
