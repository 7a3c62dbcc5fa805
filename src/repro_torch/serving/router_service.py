"""RouterService of the port (mirrors `repro.serving.router_service`): the
paper's router as the front door of a multi-model serving deployment.

  request text -> embed (encoder.py) -> KNNRouter.serve_fused ->
  argmax_m  s_hat - lambda_r * c_hat  -> dispatch to that model's engine.

The cost/quality trade-off ``lambda`` is per request (scalar or (n,)
vector), falling back to the service default and then the router's
spec-level ``default_lam``.  Per-engine circuit breakers feed an
availability mask into the selection, and `execute` reroutes a failed
wave's requests along each request's own utility order.  A service boots
from a fitted router or from an artifact of either package
(`RouterService.from_artifact`).  ``route_fused(..., degrade=)`` serves a
wave at a degradation-ladder level, `stats()` is the JSON-ready payload of
the gateway's ``/health`` and ``/stats``, and `MicroBatcher` /
`WaveScheduler` (`serving/scheduler.py`) coalesce single requests into
one ``route_fused`` a wave.

``observe`` closes the loop: routed-then-judged feedback becomes support
rows (and delta-tier index rows) in place, so the next route retrieves it;
compaction runs behind the router's ``delta_cap``, by default on a
background thread.  With a `DurabilityManager` (``durability=``) every
batch is validated, written to the write-ahead log and fsync'd BEFORE it is
applied, checkpoints follow a batch cadence and every compaction, and
`recover` (`open_recovery` + `complete_recovery`) boots a service from the
newest valid checkpoint plus the WAL suffix it does not cover.  ``close()``
joins a running compaction and writes the checkpoint it asked for.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.dataset import RoutingDataset
from repro_torch.core.routers import (Router, RouterSpec, load_router,
                                      make_router, spec_of)
from repro_torch.core.routers.knn import _select
from . import encoder as enc
from .engine import IncompleteDrainError, Request, ServingEngine
from .faults import (CircuitOpenError, DegradationLadder,
                     EngineDeadlineExceeded, EngineHealth, ExecutionReport,
                     FeedbackValidationError)


@dataclasses.dataclass
class RoutedResult:
    uid: int
    model: str
    request: Request
    predicted_score: float
    predicted_cost: float
    lam: float = 0.0
    confidence: Optional[float] = None
    #: full per-model predicted score/cost rows, kept so a failure can
    #: reroute to the next-best-utility model
    s_row: Optional[np.ndarray] = None
    c_row: Optional[np.ndarray] = None
    #: degradation-ladder level the wave was served at (0 = full fidelity)
    degradation: int = 0
    #: engines this request failed over from, in order
    rerouted_from: List[str] = dataclasses.field(default_factory=list)


def to_jsonable(obj):
    """Recursively convert a stats/report payload into plain JSON types.
    Numpy scalars and arrays and torch tensors of any device and rank leak
    easily out of routing internals; everything the gateway serializes
    onto the wire goes through here so ``json.dumps`` never raises on a
    live health endpoint."""
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return to_jsonable(obj.detach().cpu().tolist())
    if isinstance(obj, np.ndarray):
        return [to_jsonable(v) for v in obj.tolist()]
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, (bool, int, str)) or obj is None:
        return obj
    if isinstance(obj, float):
        # json.dumps emits bare `NaN`/`Infinity`, which is not JSON and
        # breaks strict clients: clamp to null
        return obj if np.isfinite(obj) else None
    return str(obj)


def knn_service(ds: RoutingDataset, engines: Dict[str, ServingEngine],
                k: int = 100, index: str = "exact", lam: float = 0.0,
                seed: int = 0, fallback_model: Optional[str] = None,
                confidence_floor: float = 0.02, encoder=None,
                **router_kw) -> "RouterService":
    """Fit a kNN router on ``ds`` (building the IVF coarse quantizer, and
    the PQ codebooks when ``index='ivfpq'``) and wrap it in a RouterService
    over ``engines``.  ``router_kw`` are KNNRouter constructor kwargs
    (weights, nprobe, m, nbits, rerank, device, ...)."""
    spec = RouterSpec("knn", k=k, ivf=index in ("ivf", "ivfpq"),
                      pq=index == "ivfpq")
    return RouterService(make_router(spec, **router_kw),
                         engines, ds=ds, lam=lam, seed=seed,
                         fallback_model=fallback_model,
                         confidence_floor=confidence_floor, encoder=encoder)


class RouterService:
    def __init__(self, router: Union[Router, RouterSpec, str],
                 engines: Dict[str, ServingEngine], *,
                 ds: Optional[RoutingDataset] = None,
                 lam: Optional[float] = None,
                 fallback_model: Optional[str] = None,
                 confidence_floor: float = 0.02, seed: int = 0,
                 breaker: Optional[Dict] = None,
                 engine_timeout_s: Optional[float] = None,
                 max_route_attempts: int = 3,
                 retry_backoff_s: float = 0.0,
                 ladder: Optional[DegradationLadder] = None,
                 encoder: Optional[enc.QueryEncoder] = None,
                 durability=None):
        if isinstance(router, (str, RouterSpec)):
            router = make_router(router)
        if router.model_names is None and ds is None:
            raise ValueError("router is not fitted; pass ds= to fit it here")
        if ds is not None:
            router.fit(ds, seed=seed)
        self.router = router
        self.engines = engines
        self.model_names = self._validate_engines(router, engines)
        self.default_lam = router.default_lam if lam is None else float(lam)
        if fallback_model is not None and fallback_model not in engines:
            raise ValueError(
                f"fallback_model {fallback_model!r} has no serving engine "
                f"(engines: {list(engines)})")
        self.fallback_model = fallback_model
        self.confidence_floor = confidence_floor
        #: query encoder; defaults to the seeded one on the router's device
        self.encoder = encoder if encoder is not None else \
            enc.default_encoder(str(getattr(router, "device", "cuda")))
        self._uid = 0
        self.observed = 0          # feedback rows ingested via observe()
        self.log: List[RoutedResult] = []
        self.health: Dict[str, EngineHealth] = {
            m: EngineHealth(m, **(breaker or {})) for m in self.model_names}
        #: wall-clock budget for one engine wave (None = no deadline)
        self.engine_timeout_s = engine_timeout_s
        self.max_route_attempts = int(max_route_attempts)
        self.retry_backoff_s = float(retry_backoff_s)
        self.ladder = ladder if ladder is not None else DegradationLadder()
        #: `repro_torch.serving.durability.DurabilityManager` (or None):
        #: every observe() batch is WAL-logged and fsync'd before it touches
        #: the index; checkpoints run on the batch cadence and after every
        #: compaction.  Duck-typed, so this module never imports it.
        self.durability = durability
        #: recovery progress ({"status": "replaying" / "ready", counters});
        #: None for a service that did not boot through recovery
        self._recovery: Optional[Dict] = None
        self._pending_replay: List = []
        if durability is not None:
            hook = getattr(self.router, "set_recluster_hook", None)
            if callable(hook):
                hook(durability.request_checkpoint)
            if not durability.checkpoints.list():
                # bootstrap snapshot: recovery always has a base to replay
                # onto, even if the process dies before the first cadence
                # checkpoint
                durability.checkpoint(self.router)

    @classmethod
    def from_artifact(cls, path, engines: Dict[str, ServingEngine], *,
                      device: str = "cuda", **kw) -> "RouterService":
        """Boot a service from a `save_router` artifact (written by either
        package) with its router on ``device`` — no training data."""
        return cls(load_router(path, device=device), engines, **kw)

    @property
    def spec(self) -> str:
        """Canonical spec string of the underlying router."""
        return spec_of(self.router)

    @property
    def retrieval_backend(self) -> str:
        """'exact' / 'ivf' / 'ivfpq': the router's retrieval index."""
        return getattr(self.router, "index", "n/a")

    @property
    def dispatch_policy(self):
        """The router's fitted `DispatchPolicy`, or None (static defaults)."""
        return getattr(self.router, "dispatch_policy", None)

    @staticmethod
    def _validate_engines(router: Router, engines: Dict) -> List[str]:
        names = list(router.model_names)
        if len(names) != len(engines):
            raise ValueError(
                f"router predicts over {len(names)} models {names} but "
                f"{len(engines)} engines were supplied ({list(engines)})")
        missing = [m for m in names if m not in engines]
        if missing:
            raise ValueError(f"router models {missing} have no serving "
                             f"engine (engines: {list(engines)})")
        return names

    # ---- health / availability ----
    def availability_mask(self) -> Optional[np.ndarray]:
        """Per-model availability from the breakers in ``model_names``
        order, or None when every engine is up (or none is: routing then
        proceeds on utilities and `execute` sheds with typed errors)."""
        flags = [self.health[m].available() for m in self.model_names]
        if all(flags) or not any(flags):
            return None
        # repro: allow-host: availability is host-side health metadata
        return np.asarray(flags, bool)

    def stats(self) -> Dict:
        """JSON-ready service health snapshot, the payload the gateway's
        ``/health`` and ``/stats`` serve: per-engine breaker state plus
        service counters, passed through `to_jsonable` so no numpy or torch
        value from the routing internals can make ``json.dumps`` raise."""
        support = getattr(self.router, "support_size", None)
        return to_jsonable({
            "spec": self.spec,
            "retrieval_backend": self.retrieval_backend,
            "default_lam": self.default_lam,
            "engines": {m: self.health[m].stats() for m in self.model_names},
            # side-effect-free availability view: a stats poll must not
            # perform the open -> half_open probe transition itself
            "available": {m: self.health[m].retry_after_s() == 0.0
                          for m in self.model_names},
            "observed": self.observed,
            "routed": len(self.log),
            "support_size": support,
            "durability": (None if self.durability is None
                           else self.durability.stats()),
            "recovery": self.recovery_status(),
        })

    # ---- lifecycle ----
    def close(self) -> None:
        """Join an in-flight background compaction, so teardown or an
        artifact save cannot race its swap, and write the checkpoint a
        finished compaction asked for.  Idempotent and safe to call
        concurrently (each caller joins the thread it observed); the
        service stays usable."""
        jr = getattr(self.router, "join_recluster", None)
        if callable(jr):
            jr()
        if self.durability is not None and self.durability.checkpoint_pending:
            with self.durability.mutex:
                self.durability.checkpoint(self.router)

    def __enter__(self) -> "RouterService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- routing ----
    def _resolve_lam(self, lam, n: int) -> np.ndarray:
        """None -> service default; scalar -> broadcast; (n,) vector as-is."""
        if lam is None:
            lam = self.default_lam
        # repro: allow-host: lambdas arrive as host request metadata
        arr = np.asarray(lam, np.float32)
        if arr.ndim == 0:
            return np.full((n,), float(arr), np.float32)
        if arr.shape != (n,):
            raise ValueError(f"lam must be a scalar or shape ({n},), got "
                             f"shape {arr.shape}")
        return arr

    def _check_arity(self, s_hat: np.ndarray) -> None:
        if s_hat.shape[1] != len(self.model_names):
            raise ValueError(
                f"router emitted {s_hat.shape[1]} model columns, expected "
                f"{len(self.model_names)} ({self.model_names})")

    def route_fused(self, emb: np.ndarray, lam=None, qmesh=None,
                    degrade: int = 0) -> tuple:
        """One routed batch through `KNNRouter.serve_fused` (retrieval,
        utility, confidence and availability-masked selection on the
        device).  ``degrade`` serves the wave at that degradation-ladder
        level (shrunk nprobe, dropped re-rank) on routers that support it.
        ``qmesh`` shards the batch over a mesh's ranks (every rank calls
        with the same batch; the index replicated; bitwise equal results).
        Returns (choice, s_hat, c_hat, agreement, lam_r) as numpy."""
        with tracing.span("service.route"):
            # repro: allow-host: input embeddings arrive as host data
            emb = np.atleast_2d(np.asarray(emb, np.float32))
            lam_r = self._resolve_lam(lam, len(emb))
            avail = self.availability_mask()
            dg = getattr(self.router, "degraded", None)
            ctx = (dg(self.ladder[degrade]) if degrade and callable(dg)
                   else contextlib.nullcontext())
            with ctx:
                choice, s_hat, c_hat, _, agree = self.router.serve_fused(
                    emb, lam_r, avail=avail, qmesh=qmesh)
            self._check_arity(s_hat)
            return choice, s_hat, c_hat, agree, lam_r

    def route_legacy(self, emb: np.ndarray, lam=None) -> tuple:
        """The staged chain (retrieval, then utility + confidence, then
        selection, with host copies between), kept as the parity oracle of
        `route_fused`.  Same return shape."""
        emb = np.atleast_2d(np.asarray(emb, np.float32))
        s_hat, c_hat, _, agree = self.router.predict_with_confidence(emb)
        self._check_arity(s_hat)
        lam_r = self._resolve_lam(lam, len(emb))
        avail = self.availability_mask()
        a = (np.ones(len(self.model_names), bool) if avail is None
             else avail)
        dev = getattr(self.router, "device", torch.device("cpu"))
        choice, _ = _select(torch.from_numpy(s_hat).to(dev),
                            torch.from_numpy(c_hat).to(dev),
                            torch.from_numpy(lam_r).to(dev),
                            torch.from_numpy(a).to(dev))
        return choice.cpu().numpy(), s_hat, c_hat, agree, lam_r

    def route_embeddings(self, emb: np.ndarray, lam=None) -> np.ndarray:
        """Per-request lambda routing over raw embeddings -> model indices
        (served through `route_fused`)."""
        return self.route_fused(emb, lam)[0]

    def submit_texts(self, texts: Sequence[str], prompts_tokens=None,
                     max_new_tokens: int = 8, lam=None,
                     degrade: int = 0) -> List[RoutedResult]:
        with tracing.span("service.submit"):
            emb = self.encoder.embed_texts(list(texts))
            choice, s_hat, c_hat, conf, lam_r = self.route_fused(
                emb, lam, degrade=degrade)
            with tracing.span("service.results"):
                results = []
                for i, text in enumerate(texts):
                    mi = int(choice[i])
                    if (conf is not None and self.fallback_model
                            and conf[i] < self.confidence_floor):
                        mi = self.model_names.index(self.fallback_model)
                    m = self.model_names[mi]
                    toks = (prompts_tokens[i] if prompts_tokens is not None
                            else enc.hash_tokenize(text)[:16])
                    toks = np.asarray(toks, np.int32)
                    vocab = self.engines[m].cfg.vocab_size
                    req = Request(uid=self._uid, prompt_tokens=toks % vocab,
                                  max_new_tokens=max_new_tokens)
                    self._uid += 1
                    results.append(RoutedResult(
                        uid=req.uid, model=m, request=req,
                        predicted_score=float(s_hat[i, mi]),
                        predicted_cost=float(c_hat[i, mi]),
                        lam=float(lam_r[i]),
                        confidence=(float(conf[i]) if conf is not None
                                    else None),
                        s_row=np.asarray(s_hat[i]).copy(),
                        c_row=np.asarray(c_hat[i]).copy(),
                        degradation=int(degrade)))
                return results

    # ---- feedback ingestion ----
    def observe(self, queries, scores, costs=None,
                recluster="background") -> int:
        """Routed-then-judged traffic becomes new support rows in place, so
        the very next route retrieves it.  ``queries``: texts (embedded by
        this service's encoder) or an (n, D) array; ``scores``: judged
        per-model quality (n, M) in ``model_names`` order; ``costs``:
        optional, same shape, default zero.  ``recluster`` as
        `KNNRouter.partial_fit` (default: compaction on a background
        thread once the tier exceeds ``delta_cap``).

        With a `DurabilityManager` the batch is validated, written to the
        WAL and fsync'd, and only then applied; every validation failure
        (`FeedbackValidationError`) is raised before the WAL write.  Returns
        the router's support size after ingestion."""
        pf = getattr(self.router, "partial_fit", None)
        if not callable(pf):
            raise TypeError(f"router {self.spec!r} does not support online "
                            f"updates (no partial_fit); use a kNN-family "
                            f"router, e.g. 'knn100-ivf@online=1'")
        emb, S, C = self._validate_feedback(queries, scores, costs)
        dur = self.durability
        if dur is None:
            pf(emb, S, C, recluster=recluster)
            self.observed += len(emb)
            return int(getattr(self.router, "support_size", -1))
        with dur.mutex:
            seq = dur.log(emb, S, C)       # fsync ack BEFORE any mutation
            pf(emb, S, C, recluster=recluster)
            dur.note_applied(seq)
            self.observed += len(emb)
            if dur.should_checkpoint():
                dur.checkpoint(self.router)
        return int(getattr(self.router, "support_size", -1))

    def _validate_feedback(self, queries, scores, costs):
        """Typed validation of one observe() batch, all before the WAL
        write.  Returns (emb, scores, costs) as f32 arrays."""
        if len(queries) == 0:
            raise FeedbackValidationError(
                "queries", "observe() got an empty batch — nothing to log "
                "or apply")
        if isinstance(queries[0], str):
            emb = self.encoder.embed_texts(list(queries))
        else:
            # repro: allow-host: feedback embeddings arrive as host data
            emb = np.atleast_2d(np.asarray(queries, np.float32))
        if emb.ndim != 2 or emb.shape[0] == 0:
            raise FeedbackValidationError(
                "queries", f"embeddings must be a non-empty (n, D) matrix, "
                           f"got shape {emb.shape}")
        dim = getattr(self.router, "embed_dim", None)
        if dim is not None and emb.shape[1] != dim:
            raise FeedbackValidationError(
                "queries", f"embedding dim {emb.shape[1]} does not match "
                           f"the router's fitted dim {dim}")
        if not np.isfinite(emb).all():
            raise FeedbackValidationError(
                "queries", "embeddings contain NaN/inf — refusing to make "
                           "non-finite support rows durable")
        M = len(self.model_names)
        S = np.atleast_2d(np.asarray(scores, np.float32))
        if S.shape != (len(emb), M):
            raise FeedbackValidationError(
                "scores", f"scores must have shape ({len(emb)}, {M}) in "
                          f"model order {self.model_names}, got {S.shape}")
        if not np.isfinite(S).all():
            raise FeedbackValidationError("scores", "scores contain NaN/inf")
        if costs is None:
            C = np.zeros_like(S)
        else:
            C = np.atleast_2d(np.asarray(costs, np.float32))
            if C.shape != S.shape:
                raise FeedbackValidationError(
                    "costs", f"costs must match scores shape {S.shape}, "
                             f"got {C.shape}")
            if not np.isfinite(C).all():
                raise FeedbackValidationError("costs",
                                              "costs contain NaN/inf")
        return emb, S, C

    # ---- durability / crash recovery ----
    def checkpoint(self):
        """Snapshot the router through the attached `DurabilityManager`
        (joining a running compaction first); None without one."""
        if self.durability is None:
            return None
        with self.durability.mutex:
            return self.durability.checkpoint(self.router)

    @classmethod
    def open_recovery(cls, root, engines: Dict[str, ServingEngine], *,
                      device: str = "cuda",
                      durability_kw: Optional[Dict] = None,
                      **service_kw) -> "RouterService":
        """Phase 1 of crash recovery: load the newest valid checkpoint
        under ``root`` onto ``device`` (corrupt snapshots are skipped,
        never loaded) and stage the WAL suffix it does not cover.  The
        service reports ``recovery_status()["status"] == "replaying"`` (a
        gateway answers readiness 503 "starting") until
        `complete_recovery` has replayed it."""
        from .durability import DurabilityManager
        dur = DurabilityManager(root, device=device, **(durability_kw or {}))
        router, covered_seq, skipped = dur.load_latest_checkpoint()
        if router is None:
            raise FileNotFoundError(
                f"no loadable checkpoint under {root!r} "
                f"(skipped corrupt: {skipped or 'none'}) — recovery needs "
                f"the bootstrap snapshot a durable service writes at "
                f"construction")
        svc = cls(router, engines, durability=dur, **service_kw)
        svc._pending_replay = dur.pending_records()
        svc._recovery = {
            "status": "replaying",
            "checkpoint_covered_seq": covered_seq,
            "corrupt_checkpoints_skipped": len(skipped),
            "skipped_detail": list(skipped),
            "wal_torn_tail_dropped": dur.wal.torn_tail_dropped,
            "pending_batches": len(svc._pending_replay),
            "replayed_batches": 0,
            "replayed_rows": 0,
        }
        return svc

    def complete_recovery(self, recluster="auto") -> int:
        """Phase 2: replay the staged WAL suffix through ``partial_fit``
        with the same batch boundaries and synchronous compaction, so the
        router converges to the uncrashed process's support and retrieval
        bits.  Replayed batches are not logged again.  Returns the batches
        replayed; the status becomes "ready"."""
        dur = self.durability
        rec = self._recovery
        if dur is None or rec is None:
            return 0
        pf = getattr(self.router, "partial_fit")
        with dur.mutex:
            for r in self._pending_replay:
                pf(r.emb, r.scores, r.costs, recluster=recluster)
                dur.note_applied(r.seq)
                self.observed += len(r.emb)
                rec["replayed_batches"] += 1
                rec["replayed_rows"] += int(len(r.emb))
            self._pending_replay = []
            rec["status"] = "ready"
        return rec["replayed_batches"]

    @classmethod
    def recover(cls, root, engines: Dict[str, ServingEngine],
                **kw) -> "RouterService":
        """Boot-time crash recovery in one call: the newest valid
        checkpoint plus the WAL suffix replayed (`open_recovery`, then
        `complete_recovery`)."""
        svc = cls.open_recovery(root, engines, **kw)
        svc.complete_recovery()
        return svc

    def recovery_status(self) -> Optional[Dict]:
        """Replay progress ({"status": "replaying" / "ready", counters}),
        or None for a service that did not boot through recovery."""
        return None if self._recovery is None else dict(self._recovery)

    # ---- execution ----
    def _run_engine(self, m: str, reqs: List[Request]) -> int:
        """One wave on one engine under the service deadline (a worker
        thread and a join timeout when ``engine_timeout_s`` is set).  A
        worker past its deadline cannot cancel the work it queued on the
        card and keeps the engine's slots; reroutes hand fresh Requests to
        the next engine instead."""
        eng = self.engines[m]
        if self.engine_timeout_s is None:
            return eng.run_until_drained(reqs)
        box: Dict = {}

        def worker():
            try:
                box["steps"] = eng.run_until_drained(reqs)
            except BaseException as exc:
                box["exc"] = exc

        t = threading.Thread(target=worker, daemon=True,
                             name=f"engine-wave-{m}")
        t.start()
        t.join(self.engine_timeout_s)
        if t.is_alive():
            raise EngineDeadlineExceeded(m, self.engine_timeout_s)
        if "exc" in box:
            raise box["exc"]
        return box["steps"]

    def _next_best(self, r: RoutedResult, tried: Set[str]) -> Optional[str]:
        """Next model along the request's own utility order, skipping
        engines already tried and engines whose breaker is open."""
        util = np.asarray(r.s_row, np.float32) - r.lam * np.asarray(
            r.c_row, np.float32)
        for mi in np.argsort(-util, kind="stable"):
            m = self.model_names[int(mi)]
            if m not in tried and self.health[m].available():
                return m
        return None

    def _reroute(self, rs: List[RoutedResult], exc: BaseException,
                 report: ExecutionReport, attempts: Dict[int, int],
                 tried: Dict[int, Set[str]]
                 ) -> List[Tuple[str, RoutedResult]]:
        """Failover: each request goes to its next-best available engine as
        a fresh Request that takes over the old one's ``on_token`` stream
        (tokens a partly served attempt already streamed stay streamed), or
        lands in ``report.failed`` with a typed reason.  Never a silent
        drop."""
        requeued = []
        for r in rs:
            tried.setdefault(r.uid, set()).add(r.model)
            attempts[r.uid] = attempts.get(r.uid, 0) + 1
            nxt = (self._next_best(r, tried[r.uid])
                   if attempts[r.uid] < self.max_route_attempts else None)
            if nxt is None:
                if not r.request.error:
                    r.request.error = type(exc).__name__
                report.failed[r.uid] = f"{type(exc).__name__}: {exc}"
                continue
            report.rerouted.append((r.uid, r.model, nxt))
            r.rerouted_from.append(r.model)
            old = r.request
            vocab = self.engines[nxt].cfg.vocab_size
            # the stream moves to the fresh Request; the failed engine
            # (possibly still hung on the old one) can no longer feed it
            r.request = Request(
                uid=r.uid,
                prompt_tokens=np.asarray(old.prompt_tokens,
                                         np.int64) % vocab,
                max_new_tokens=old.max_new_tokens, on_token=old.on_token,
                cancelled=old.cancelled)
            old.on_token = None
            r.model = nxt
            mi = self.model_names.index(nxt)
            r.predicted_score = float(r.s_row[mi])
            r.predicted_cost = float(r.c_row[mi])
            requeued.append((nxt, r))
        return requeued

    def execute(self, results: List[RoutedResult]) -> ExecutionReport:
        """Dispatch routed requests to their engines, wave by wave and
        engine by engine, isolating failures: an open breaker skips the
        engine, a failure or timeout records to its breaker and reroutes
        the affected requests, a success re-closes it.  The results join
        ``self.log``."""
        report = ExecutionReport()
        queue: List[Tuple[str, RoutedResult]] = [(r.model, r)
                                                 for r in results]
        attempts: Dict[int, int] = {}
        tried: Dict[int, Set[str]] = {}
        while queue:
            by_model: Dict[str, List[RoutedResult]] = {}
            for m, r in queue:
                by_model.setdefault(m, []).append(r)
            queue = []
            for m, rs in by_model.items():
                health = self.health[m]
                if not health.available():
                    report.skipped[m] = report.skipped.get(m, 0) + 1
                    exc = CircuitOpenError(
                        m, retry_after_s=health.retry_after_s())
                    queue.extend(self._reroute(rs, exc, report, attempts,
                                               tried))
                    continue
                reqs = [r.request for r in rs]
                try:
                    steps = self._run_engine(m, reqs)
                except IncompleteDrainError as exc:
                    health.record_failure(exc)
                    report.record_error(m, exc,
                                        [q.uid for q in exc.survivors])
                    surv = {id(q) for q in exc.survivors}
                    failed_rs = [r for r in rs if id(r.request) in surv]
                    queue.extend(self._reroute(failed_rs, exc, report,
                                               attempts, tried))
                except Exception as exc:
                    health.record_failure(exc)
                    report.record_error(m, exc, [r.uid for r in rs])
                    if not isinstance(exc, EngineDeadlineExceeded):
                        self.engines[m].release(reqs)
                    queue.extend(self._reroute(rs, exc, report, attempts,
                                               tried))
                else:
                    health.record_success()
                    report[m] = report.get(m, 0) + steps
            if queue and self.retry_backoff_s:
                time.sleep(self.retry_backoff_s)
        self.log.extend(results)
        return report

    def serve_texts(self, texts: Sequence[str], **kw):
        results = self.submit_texts(texts, **kw)
        self.execute(results)
        return results
