"""The paper's protagonist in the port: the k-Nearest-Neighbour router
(mirrors `repro.core.routers.knn`).

Utility prediction: s_hat(x, m) = mean over the k nearest support rows of
s(x_i, m) (optionally similarity-softmax weighted); identically for costs.

Retrieval (``index=``):

  * ``"exact"`` — the exact cosine top-k kernel (`kernels.knn_topk`) over
    the device-resident support rows;
  * ``"ivf"`` — inverted-file approximate retrieval (`kernels.knn_ivf`): a
    spherical k-means coarse quantizer fit at ``fit`` time; each query
    probes its ``nprobe`` nearest lists and kernel 4 scores only those;
  * ``"ivfpq"`` — product-quantized IVF: kernel 5 scores the probed lists'
    packed ``m``-byte codes by ADC into a shortlist of ``rerank * k``
    candidates, re-scored exactly against the raw rows.

``serve_fused`` runs retrieval, utility, confidence and the per-request-
lambda, availability-masked selection on the device and copies the
results to the host at the end; the staged calls (``predict_utility``,
``confidence``, ``predict_with_confidence``) share the same tail
functions, so both give the same numbers.  Retrieval slots no support row
fills (id -1) are excluded from averages and votes.

Sharded (``mesh=``, a ``DeviceMesh`` of `launch.mesh`; every rank of it
calls the router with the same batch): retrieval goes through
`core.sharded_knn`, the support rows (or the index's lists) split over
the mesh's ranks and each rank's kernel run on its own shard, merged by
one all-gather; the decision tail runs on every rank over the merged
neighbours.  ``serve_fused(qmesh=)`` shards the BATCH instead: the index
is replicated (each rank's router holds it on its card, made once per
index version by fit, load or compaction), rank r routes its block of
the batch padded to a multiple of the ranks, and the five outputs are
all-gathered and cut back to Q, bitwise equal to the unsharded route.
``mesh`` is a handle of the process group, not configuration: it stays
out of the manifest, as in the reference.

The reference's execution-backend knobs (``use_pallas``, ``backend``) are
accepted so that spec strings and artifact manifests load; here a CUDA
router always runs the kernels and a CPU router their plain versions.  A
fitted `DispatchPolicy` (``router.dispatch_policy``) is carried as the
reference carries it: `resolve_backend` returns the reference's pick, its
tuned tiles (`kernels.knn_ivf.autotune`) reach the kernels — ``block_q``
is kernel 4's query tile (without one the batch picks it,
`ops.block_q_for`), ``lane_pad`` shapes the index built at ``fit``;
``probe_chunk`` is carried only, kernel 5's shape picks its path — and
its wave constants reach `MicroBatcher.from_policy`.  The tiles change
times, never bits.  ``degraded(level)`` serves one wave at
a degradation-ladder level (smaller ``nprobe``, no exact re-rank, no
delta tier).

Streaming updates: ``partial_fit(X, scores, costs)`` appends observations
to the support arrays; for the approximate indexes the rows also land in a
`DynamicIVFIndex` delta tier that the very next route retrieves (probed
per-centroid sub-lists on the fused backend, an exact scan of the whole
tier on the staged ones: the backend picks the neighbours once there is a
tier, as in the reference) and that is compacted by a full re-cluster once
it exceeds ``delta_cap``, synchronously or on a background thread
(``recluster="background"``).  ``online=True`` (spec
``@online=1,delta_cap=..``) wraps the index at fit time, otherwise the
first ``partial_fit`` wraps it.  The device copies of the support (and the
exact index's rows) have power-of-two capacities and grow by copies of the
appended rows; they grow BEFORE the index appends, so every id a search can
return is covered by the support a route reads after it.

Selection formulation: ``fit_selection(ds, lam)`` stores the gold labels
of the support rows at ``lam`` (``_train_best``), and ``select(X)`` is the
neighbours' majority vote over them (ties to the lower model id), on the
neighbours of whichever index the router uses.  ``partial_fit`` extends
the labels at the same lambda, so the vote covers every support row.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.distributed import comm
from repro_torch.kernels.knn_ivf.ops import (DEFAULT_DELTA_CAP,
                                             DEFAULT_NPROBE, DEFAULT_RERANK,
                                             DynamicIVFIndex,
                                             build_ivf_index, check_backend,
                                             build_ivfpq_index, ivf_topk,
                                             ivfpq_topk)
from repro_torch.kernels.knn_topk.ops import knn_topk
from repro_torch.launch.mesh import flat_shard_id, mesh_group
from .. import sharded_knn
from ..dataset import RoutingDataset
from .base import Router, gold_labels, normalize_rows
from .spec import register

_INDEXES = ("exact", "ivf", "ivfpq")

# ---------------------------------------------------------------------------
# neighbour -> decision tail, shared by the staged calls and serve_fused
# ---------------------------------------------------------------------------

def _utility(sims, idx, S, C, *, weights: str, temperature: float):
    """Neighbour-weighted utility/cost estimates from one retrieval's
    (sims, idx); empty slots (idx == -1) get zero weight."""
    valid = idx >= 0
    safe = idx.clamp_min(0).long()
    s_nb = S[safe]                                           # (Q, k, M)
    c_nb = C[safe]
    if weights == "softmax":
        fin = torch.where(valid, sims, torch.full_like(sims, float("-inf")))
        mx = fin.max(dim=1, keepdim=True).values
        mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
        w = torch.exp(temperature * (fin - mx))
        w = w / w.sum(dim=1, keepdim=True).clamp_min(1e-12)
    else:
        v = valid.float()
        w = v / v.sum(dim=1, keepdim=True).clamp_min(1.0)
    s_hat = torch.einsum("qk,qkm->qm", w, s_nb)
    c_hat = torch.einsum("qk,qkm->qm", w, c_nb)
    return s_hat, c_hat


def _confidence(sims, idx, S):
    """(kth_sim, neighbour_agreement): the k-th similarity as the row min
    (scores arrive sorted, so it equals the last column), and the mode
    fraction of the valid neighbours' best-model votes."""
    kth = sims.min(dim=1).values
    valid = idx >= 0
    best = S[idx.clamp_min(0).long()].argmax(dim=2)            # (Q, k)
    M = S.shape[1]
    votes = (best[..., None] == torch.arange(M, device=S.device)) \
        & valid[..., None]
    counts = votes.sum(dim=1)                                  # (Q, M)
    agree = counts.max(dim=1).values.float() \
        / valid.sum(dim=1).clamp_min(1).float()
    return kth, agree


def _select(s_hat, c_hat, lam, avail):
    """Per-request-lambda utility argmax; models with ``avail`` False score
    -inf.  Ties go to the first model, like `jnp.argmax`.  Returns
    (choice, unmasked utilities)."""
    util = s_hat - lam[:, None] * c_hat
    masked = torch.where(avail[None, :], util,
                         torch.full_like(util, float("-inf")))
    return masked.argmax(dim=1), util


def _serve_tail(sims, idx, S, C, lam, avail, *, weights: str,
                temperature: float):
    """Retrieval results -> (choice, s_hat, c_hat, kth, agree)."""
    s_hat, c_hat = _utility(sims, idx, S, C, weights=weights,
                            temperature=temperature)
    kth, agree = _confidence(sims, idx, S)
    choice, _ = _select(s_hat, c_hat, lam, avail)
    return choice, s_hat, c_hat, kth, agree


@register("knn", k_param="k", default_ks=(10, 100), supports_ivf=True,
          paper_rank=0)
class KNNRouter(Router):
    is_parametric = False
    state_attrs = ("_X", "_S", "_C", "_ivf", "_train_best", "_sel_lam")

    def __init__(self, k: int = 100, weights: str = "uniform",
                 use_pallas: bool = False, temperature: float = 20.0,
                 mesh=None, index: str = "exact",
                 n_clusters: int | None = None,
                 nprobe: int = DEFAULT_NPROBE, m: int | None = None,
                 nbits: int = 8, rerank: int = DEFAULT_RERANK,
                 online: bool = False, delta_cap: int = DEFAULT_DELTA_CAP,
                 backend: str | None = None, device: str = "cuda"):
        if weights not in ("uniform", "softmax"):
            raise ValueError(f"weights must be 'uniform' or 'softmax', got "
                             f"{weights!r}")
        if index not in _INDEXES:
            raise ValueError(f"index must be one of {_INDEXES}, "
                             f"got {index!r}")
        check_backend(backend)
        self.k = k
        self.weights = weights
        self.use_pallas = use_pallas
        self.temperature = temperature
        self.mesh = mesh
        self.index = index
        self.n_clusters = n_clusters
        self.nprobe = nprobe
        self.m = m
        self.nbits = nbits
        self.rerank = rerank
        self.online = bool(online)
        self.delta_cap = int(delta_cap)
        self.backend = backend
        self.device = torch.device(device)
        #: degradation state set by `degraded` for one wave: serve the
        #: streaming index's base only
        self._skip_delta = False
        #: fitted `DispatchPolicy` (or None = static defaults), set by an
        #: artifact load, not a constructor parameter, so spec strings and
        #: ``router_config`` stay policy-free
        self.dispatch_policy = None
        self._dev = {}           # device-resident support + mask cache
        self._recluster_hook = None
        suffix = {"exact": "", "ivf": " IVF", "ivfpq": " IVF-PQ"}[index]
        self.name = f"kNN (k={k}){suffix}"

    @property
    def exec_backend(self) -> str:
        """The reference's execution backend of the approximate tiers:
        explicit ``backend`` wins, then ``use_pallas``, then ``fused`` for
        IVF-PQ and ``host`` for raw IVF.  Every name runs the same kernels
        here (a CUDA router) or their plain versions (a CPU router)."""
        if self.backend is not None:
            return self.backend
        if self.use_pallas:
            return "pallas"
        return "fused" if self.index == "ivfpq" else "host"

    # ---- measured dispatch policy ----
    def _policy_tiles(self) -> dict:
        """Autotuned kernel constants for this index kind from the fitted
        dispatch policy ({} when no policy / nothing tuned).  ``lane_pad``
        shapes the index built at ``fit``; ``block_q`` is kernel 4's query
        tile (8, 16, 32 or 64, checked when the policy is made), passed by
        `_search`; ``probe_chunk`` is carried for the reference and names
        nothing here."""
        pol = getattr(self, "dispatch_policy", None)
        return pol.tiles_for(self.index) if pol is not None else {}

    def _delta_frac(self) -> float:
        """Fraction of served rows in the streaming delta tier: the dispatch
        policy's third axis."""
        ivf = getattr(self, "_ivf", None)
        if isinstance(ivf, DynamicIVFIndex):
            snap = ivf.fused_state()
            if snap.n_rows:
                # repro: allow-unlocked: immutable snapshot taken under the lock
                return (snap.n_rows - snap.base.n_rows) / snap.n_rows
        return 0.0

    def resolve_backend(self, n_queries: int | None = None) -> str:
        """The reference's serving backend for a batch of ``n_queries``:
        explicit ``backend=`` wins, then ``use_pallas``, then the fitted
        `DispatchPolicy` cell for (index, batch, delta fraction), then the
        static default.  On a frozen index every name runs the same
        kernels; with a delta tier ``"fused"`` probes the delta sub-lists
        and the others scan the whole tier exactly, so from there on the
        policy picks the neighbours, not only the speed (as it does in the
        reference)."""
        if self.backend is not None:
            return self.backend
        if self.use_pallas:
            return "pallas"
        pol = getattr(self, "dispatch_policy", None)
        if pol is not None and n_queries:
            be = pol.exec_backend_for(self.index, int(n_queries),
                                      self._delta_frac())
            if be is not None:
                return be
        return "fused" if self.index in ("ivfpq", "exact") else "host"

    def join_recluster(self) -> None:
        """Block until an in-flight background compaction has swapped in
        (no-op otherwise): the teardown hook of `RouterService.close`."""
        ivf = getattr(self, "_ivf", None)
        if isinstance(ivf, DynamicIVFIndex):
            ivf.join_recluster()

    def set_recluster_hook(self, fn) -> None:
        """Register ``fn()`` to run after every compaction swap (the
        durability layer's checkpoint trigger), on the live
        `DynamicIVFIndex` now and on one `partial_fit` wraps later.  It may
        run on the background rebuild thread: flag-setting only."""
        self._recluster_hook = fn
        ivf = getattr(self, "_ivf", None)
        if isinstance(ivf, DynamicIVFIndex):
            ivf.on_recluster = fn

    # ---- deadline-driven graceful degradation ----
    @contextlib.contextmanager
    def degraded(self, level=None):
        """Serve the enclosed wave at a degradation level: any object with
        ``nprobe_scale`` / ``rerank`` / ``skip_delta`` attributes (see
        `repro_torch.serving.faults.DegradationLevel`; duck-typed so the
        router never imports the serving layer).  ``nprobe`` and ``rerank``
        are restored on exit, also when the block raises.  ``None`` or
        level 0 is a no-op.  Not re-entrant across threads: the serving
        loop applies it from its single routing thread."""
        if level is None or not (level.nprobe_scale != 1.0
                                 or level.rerank is not None
                                 or level.skip_delta):
            yield
            return
        saved = (self.nprobe, self.rerank, self._skip_delta)
        try:
            self.nprobe = max(1, int(round(self.nprobe
                                           * level.nprobe_scale)))
            if level.rerank is not None:
                self.rerank = int(level.rerank)
            self._skip_delta = bool(level.skip_delta)
            yield
        finally:
            self.nprobe, self.rerank, self._skip_delta = saved

    # ---- fit = store the support set (+ coarse quantizer / PQ codebooks) --
    def _index_build_kw(self, seed: int) -> dict:
        """Builder kwargs a `DynamicIVFIndex` re-cluster replays so the
        compacted index equals a from-scratch build bitwise."""
        kw = {"n_clusters": self.n_clusters, "seed": seed}
        if self.index == "ivfpq":
            kw.update(m=self.m, nbits=self.nbits)
        lp = self._policy_tiles().get("lane_pad")
        if lp:
            kw["lane_pad"] = int(lp)
        return kw

    def _wrap_dynamic(self, seed: int) -> None:
        self._ivf = DynamicIVFIndex(self._ivf, delta_cap=self.delta_cap,
                                    build_kw=self._index_build_kw(seed))
        self._ivf.on_recluster = self._recluster_hook

    def fit(self, ds: RoutingDataset, seed: int = 0) -> "KNNRouter":
        self._record_fit(ds, seed)
        self._dev = {}
        X, S, C = ds.part("train")
        self._X = normalize_rows(X)
        self._S = S.astype(np.float32)
        self._C = C.astype(np.float32)
        self._ivf = None
        # a policy-tuned lane_pad applies at build time, as in the reference
        lp = self._policy_tiles().get("lane_pad")
        lane = {"lane_pad": int(lp)} if lp else {}
        if self.index == "ivf":
            self._ivf = build_ivf_index(self._X, self.n_clusters, seed=seed,
                                        device=self.device, **lane)
        elif self.index == "ivfpq":
            self._ivf = build_ivfpq_index(self._X, self.n_clusters, m=self.m,
                                          nbits=self.nbits, seed=seed,
                                          device=self.device, **lane)
        if self.online and self.index != "exact":
            self._wrap_dynamic(seed)
        return self

    # ---- streaming updates: appending a row IS the whole training step ----
    def partial_fit(self, X: np.ndarray, scores: np.ndarray,
                    costs: np.ndarray | None = None,
                    recluster="auto") -> "KNNRouter":
        """Absorb new (embedding, per-model score/cost) observations without
        refitting: rows are appended to the support arrays and, for the
        approximate indexes, to the index's delta tier, so the very next
        route can retrieve them.  ``costs`` defaults to zero.

        ``recluster``: ``"auto"`` compacts once the tier exceeds
        ``delta_cap``; ``False`` never compacts; ``True`` compacts now;
        ``"background"`` has the trigger of ``"auto"`` with the rebuild on
        a daemon thread and an atomic swap.  A frozen approximate index is
        wrapped into a `DynamicIVFIndex` on the first call."""
        if getattr(self, "_S", None) is None:
            raise RuntimeError("KNNRouter.partial_fit() called before fit(); "
                               "the streaming step appends to a fitted "
                               "support set")
        X = np.atleast_2d(np.asarray(X, np.float32))
        S = np.atleast_2d(np.asarray(scores, np.float32))
        M = self._S.shape[1]
        if S.shape != (len(X), M):
            raise ValueError(f"scores must have shape ({len(X)}, {M}) to "
                             f"match the fitted model axis, got {S.shape}")
        if costs is None:
            C = np.zeros_like(S)
        else:
            C = np.atleast_2d(np.asarray(costs, np.float32))
            if C.shape != S.shape:
                raise ValueError(f"costs must match scores shape {S.shape}, "
                                 f"got {C.shape}")
        Xn = normalize_rows(X)
        X_all = np.concatenate([self._X, Xn])
        S_all = np.concatenate([self._S, S])
        C_all = np.concatenate([self._C, C])
        # the device support grows first: an id the index returns after the
        # append below is always covered by the support a route reads
        self._grow("S", S_all)
        self._grow("C", C_all)
        if self.index == "exact":
            self._grow("X", X_all)
        self._X, self._S, self._C = X_all, S_all, C_all
        if getattr(self, "_train_best", None) is not None:
            # keep the selection vote consistent: extend the gold labels at
            # the lambda fit_selection derived them with
            lam = self._sel_lam if self._sel_lam is not None else 0.0
            self._train_best = np.concatenate(
                [self._train_best, gold_labels(S, C, lam)])
        if self.index != "exact":
            if not isinstance(self._ivf, DynamicIVFIndex):
                self._wrap_dynamic(self.fit_seed or 0)
            self._ivf.append(Xn)
            if recluster is True:
                self._ivf.recluster()
            elif recluster == "auto":
                self._ivf.maybe_recluster()
            elif recluster == "background":
                self._ivf.maybe_recluster(sync=False)
        return self

    @property
    def support_size(self) -> int:
        """Rows currently backing retrieval (grows under partial_fit)."""
        return 0 if getattr(self, "_S", None) is None else len(self._S)

    def _grow(self, name: str, host: np.ndarray) -> None:
        """Bring the device copy ``name`` up to ``host``'s rows.  The buffer
        has a power-of-two capacity, and only rows it does not hold yet are
        copied in (into a doubled buffer when it is full); ``host`` only
        ever grows by appends between fits, so the rows it holds stand.  A
        route holding an older view keeps reading the rows it had."""
        ent = self._dev.get(name)
        n = len(host)
        buf, lo = (None, 0) if ent is None else ent
        if buf is None or buf.shape[0] < n:
            new = torch.empty((1 << max(0, (n - 1).bit_length()),)
                              + host.shape[1:], dtype=torch.float32,
                              device=self.device)
            if lo:
                new[:lo] = buf[:lo]
            buf = new
        if lo < n:
            buf[lo:n] = torch.from_numpy(host[lo:n]).to(self.device)
            tracing.count(tracing.HOST_SYNCS)
        self._dev[name] = (buf, max(lo, n))

    def _dev_rows(self, name: str, host: np.ndarray) -> torch.Tensor:
        ent = self._dev.get(name)
        if ent is None or ent[1] < len(host):
            self._grow(name, host)
            ent = self._dev[name]
        return ent[0][:len(host)]

    def _support_dev(self):
        """Device-resident (S, C) views over the support's rows."""
        return self._dev_rows("S", self._S), self._dev_rows("C", self._C)

    def _search(self, q, backend: str | None = None):
        """One retrieval over the device index: q (Q, D) unit rows on the
        device -> (sims, idx) device tensors, (Q, k) with k clamped as the
        reference clamps it.  ``backend`` (default `exec_backend`) matters
        only to a streaming index; a degraded wave (``_skip_delta``)
        searches its base only; the policy's ``block_q`` is kernel 4's
        query tile.  With a ``mesh`` the search is sharded over it
        (`core.sharded_knn`; a streaming index merges its delta tier's
        exact scan, as the staged backends do)."""
        be = backend or self.exec_backend
        ivf = getattr(self, "_ivf", None)
        if self._skip_delta and isinstance(ivf, DynamicIVFIndex):
            ivf = ivf.fused_state().base
        if self.mesh is not None:
            return self._sharded_search(q, ivf)
        if self.index == "ivf":
            return ivf_topk(q, ivf, self.k, nprobe=self.nprobe, backend=be,
                            block_q=self._policy_tiles().get("block_q"))
        if self.index == "ivfpq":
            return ivfpq_topk(q, ivf, self.k, nprobe=self.nprobe,
                              rerank=self.rerank, backend=be)
        X = self._dev_rows("X", self._X)
        return knn_topk(q, X, min(self.k, X.shape[0]))

    def _sharded_search(self, q, ivf):
        if self.index == "ivf":
            return sharded_knn.sharded_ivf_topk(
                q, ivf, self.k, self.mesh, nprobe=self.nprobe,
                block_q=self._policy_tiles().get("block_q"))
        if self.index == "ivfpq":
            return sharded_knn.sharded_ivfpq_topk(
                q, ivf, self.k, self.mesh, nprobe=self.nprobe,
                rerank=self.rerank)
        return sharded_knn.sharded_knn_topk(q, self._support_shard(),
                                            min(self.k, len(self._X)),
                                            self.mesh)

    def _support_shard(self) -> "sharded_knn.LocalShard":
        """This rank's rows of the exact support on its card, cut from the
        host rows once for each support size and mesh (``partial_fit``
        grows the support; the shard is laid out anew)."""
        key = (len(self._X), self.mesh)
        ent = self._dev.get("X_shard")
        if ent is None or ent[0] != key:
            sh = sharded_knn.shard_support(torch.from_numpy(self._X),
                                           self.mesh)
            ent = (key, sharded_knn.LocalShard(sh.rows.to(self.device),
                                               sh.n_valid))
            self._dev["X_shard"] = ent
        return ent[1]

    def _queries(self, X):
        # repro: allow-host: input embeddings arrive as host data
        X = np.atleast_2d(np.asarray(X, np.float32))
        # repro: allow-host: the batch's one copy of its queries to the card
        return torch.from_numpy(normalize_rows(X)).to(self.device)

    def _neighbors(self, X, backend: str | None = None):
        """One retrieval pass -> numpy (sims, idx)."""
        sims, idx = self._search(self._queries(X), backend)
        return sims.cpu().numpy(), idx.cpu().numpy()

    # ---- utility ----
    def _utility_from(self, sims, idx):
        S, C = self._support_dev()
        s_hat, c_hat = _utility(
            torch.as_tensor(sims, device=self.device),
            torch.as_tensor(idx, device=self.device), S, C,
            weights=self.weights, temperature=float(self.temperature))
        return s_hat.cpu().numpy(), c_hat.cpu().numpy()

    def predict_utility(self, X: np.ndarray):
        return self._utility_from(*self._neighbors(X))

    # ---- selection: neighbour majority vote ----
    def fit_selection(self, ds: RoutingDataset, lam: float, seed: int = 0):
        self.fit(ds, seed=seed)
        _, S, C = ds.part("train")
        self._sel_lam = float(lam)      # partial_fit extends the vote labels
        self._train_best = gold_labels(S, C, lam)
        return self

    def select(self, X: np.ndarray) -> np.ndarray:
        if getattr(self, "_train_best", None) is None:
            raise RuntimeError("KNNRouter.select() called before "
                               "fit_selection(); the neighbour vote needs the "
                               "training labels derived at a fixed lambda")
        _, idx = self._neighbors(X)
        valid = idx >= 0
        votes = self._train_best[np.maximum(idx, 0)]   # (Q, k)
        M = self._S.shape[1]
        counts = np.stack([((votes == m) & valid).sum(1) for m in range(M)],
                          axis=1)
        return np.argmax(counts, axis=1)

    # ---- practitioner diagnostics (§8): per-query confidence ----
    def _confidence_from(self, sims, idx):
        S, _ = self._support_dev()
        kth, agree = _confidence(torch.as_tensor(sims, device=self.device),
                                 torch.as_tensor(idx, device=self.device), S)
        return kth.cpu().numpy(), agree.cpu().numpy()

    def confidence(self, X: np.ndarray):
        """(kth_sim, neighbour_agreement) per query."""
        return self._confidence_from(*self._neighbors(X))

    def predict_with_confidence(self, X: np.ndarray):
        """One retrieval feeding both outputs: (s_hat, c_hat, kth_sim,
        agreement)."""
        sims, idx = self._neighbors(X)
        s_hat, c_hat = self._utility_from(sims, idx)
        kth, agree = self._confidence_from(sims, idx)
        return s_hat, c_hat, kth, agree

    # ---- device-side serving path ----
    def _avail_dev(self, avail=None):
        """Per-model availability mask (bool, (M,)) on the device; ``None``
        means every model is up.  Cached by content."""
        M = self._S.shape[1]
        if avail is None:
            a = np.ones((M,), bool)
        else:
            # repro: allow-host: availability arrives as host health metadata
            a = np.asarray(avail, dtype=bool).reshape(-1)
        if a.shape != (M,):
            raise ValueError(f"availability mask must have shape ({M},) to "
                             f"match the model axis, got {a.shape}")
        if not a.any():
            raise ValueError("availability mask excludes every model; "
                             "routing has no candidate to select")
        key = a.tobytes()
        if self._dev.get("avail_key") != key:
            self._dev["avail"] = torch.from_numpy(a).to(self.device)
            self._dev["avail_key"] = key
            tracing.count(tracing.HOST_SYNCS)
        return self._dev["avail"]

    @torch.no_grad()
    def serve_fused(self, X: np.ndarray, lam: np.ndarray, avail=None,
                    qmesh=None):
        """One routed batch on the device: retrieval kernel, neighbour
        utility, confidence and per-request-lambda availability-masked
        selection, copied to the host once, at the end.  Returns numpy
        (choice, s_hat, c_hat, kth_sim, agreement).  Retrieval runs on the
        backend `resolve_backend` picks for the batch.  ``qmesh`` shards
        the batch over its ranks (`_serve_sharded`), bitwise equal to the
        unsharded route."""
        with tracing.span("router.serve"):
            # repro: allow-host: lambdas arrive as host request metadata
            lam_t = torch.from_numpy(np.asarray(lam, np.float32).reshape(-1)).to(
                self.device)
            tracing.count(tracing.HOST_SYNCS)
            with tracing.span("router.search"):
                q = self._queries(X)
                tracing.count(tracing.HOST_SYNCS)
                av = self._avail_dev(avail)
                if qmesh is None:
                    sims, idx = self._search(q, self.resolve_backend(len(q)))
            if qmesh is not None:
                out = self._serve_sharded(qmesh, q, lam_t, av)
            else:
                with tracing.span("router.tail"):
                    # read after the search: the support covers every id
                    # it returned
                    S, C = self._support_dev()
                    out = _serve_tail(sims, idx, S, C, lam_t, av,
                                      weights=self.weights,
                                      temperature=float(self.temperature))
            with tracing.span("router.d2h"):
                tracing.count(tracing.HOST_SYNCS, len(out))
                # repro: allow-host: the single end-of-batch materialization
                return tuple(o.cpu().numpy() for o in out)

    def _serve_sharded(self, qmesh, q, lam, avail):
        """The fused route with the batch sharded over ``qmesh``: the batch
        padded with zero queries to a multiple of the ranks, rank r routes
        rows ``[r per, (r + 1) per)`` over its replicated index (on the
        backend the whole batch resolves to), and one all-gather of the
        five outputs side by side (their bits, the int64 choices as two
        f32 words) gives every rank the batch, cut back to Q.  Every lane
        of the route is independent of the others, so the result equals
        the unsharded route bitwise."""
        if self.mesh is not None:
            raise ValueError("serve_fused: qmesh shards the batch over a "
                             "replicated index; this router's mesh shards "
                             "the index itself")
        n, qn = qmesh.size(), q.shape[0]
        per = -(-qn // n)
        lo = flat_shard_id(qmesh) * per
        q = F.pad(q, (0, 0, 0, n * per - qn))[lo:lo + per].contiguous()
        lam = F.pad(lam, (0, n * per - qn))[lo:lo + per]
        sims, idx = self._search(q, self.resolve_backend(qn))
        S, C = self._support_dev()
        choice, s_hat, c_hat, kth, agree = _serve_tail(
            sims, idx, S, C, lam, avail, weights=self.weights,
            temperature=float(self.temperature))
        M = s_hat.shape[1]
        buf = torch.cat([choice.contiguous().view(torch.float32)
                         .reshape(per, 2), s_hat, c_hat, kth[:, None],
                         agree[:, None]], 1)
        got = comm.all_gather(buf, mesh_group(qmesh)).reshape(n * per, -1)
        got = got[:qn]
        return (got[:, :2].contiguous().view(torch.int64).reshape(qn),
                got[:, 2:2 + M], got[:, 2 + M:2 + 2 * M],
                got[:, 2 + 2 * M], got[:, 3 + 2 * M])

    # ---- artifact contract: don't store the support rows twice ----
    def state_dict(self):
        """The approximate indexes already hold every support row (IVF-PQ's
        flat cold tier, IVF's cluster-major lists), so ``_X`` is left out
        for them and rebuilt at load, as the reference does."""
        state = super().state_dict()
        if self.index != "exact":
            state.pop("_X", None)
        return state

    def load_state_dict(self, state):
        super().load_state_dict(state)
        self._dev = {}
        ivf = getattr(self, "_ivf", None)
        if isinstance(ivf, DynamicIVFIndex):
            ivf.on_recluster = self._recluster_hook
        if getattr(self, "_X", None) is None and ivf is not None:
            if isinstance(ivf, DynamicIVFIndex):
                self._X = ivf.all_rows()           # base + pending delta
            else:
                self._X = ivf.rows()               # exact float copies
        return self
