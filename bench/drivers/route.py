"""Route cells: texts routed through the port's `MicroBatcher` ->
`RouterService.submit_texts` -> `QueryEncoder.embed_texts` and
`KNNRouter.serve_fused` (kernel 1 over the support, the decision tail).

Set-up makes, from the seed: the query encoder's weights; the support (the
prototypes' embeddings by the plain reference encoder, each expanded on
the card to paraphrases by a seeded perturbation, with scores of topic
affinity plus noise and a fixed cost a model); the idle pool's weights;
and the requests' texts and lambdas.  The port is handed the weights and
the support as any caller would hand them, and the cell's wave shapes are
warmed.

The window is one of two loops, by the mix's ``kind``:

- ``route_backlog``: the queue is refilled to a full wave before each
  flush; ``routes_per_s`` is every route completed over the window's time;
- ``route_open``: requests are submitted when due (`bench.traffic`
  arrivals) and every pending wave is flushed at once (the batcher's
  default, no close timeout); ``route_p95_ms`` is the 95th percentile over
  every request due in the window of the time from its due time to the
  end of the flush that answered it.

What is judged (`check`): a sample of the window's requests drawn from
the seed (each request number with probability ``check_share``), with the
longest texts in it, each against the plain reference on
its own text and lambda: the encoder's embedding, the k-th neighbour's
similarity, and, where the reference's k-th and (k+1)-th similarities are
apart by more than the tie margin (so the neighbour set is decided), the
predicted scores and costs, the agreement and the choice; besides, every
request must be answered, under its own ticket, with its own lambda.
"""
from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from bench import common, plain
from bench import traffic as T
from bench.profiling import Spans

#: the numbers compared, each against its limit in ``limits/<cell>.json``
CHECKS = ("emb_gap", "kth_gap", "util_gap", "agree_gap", "choice_mismatch",
          "lam_mismatch", "unanswered")


class Cell:
    def __init__(self, spec):
        self.cfg = spec.cfg
        self.tp = spec.traffic
        self.seed = spec.seed
        self.dev = torch.device(spec.device)
        self.ref = common.reference(spec.config_name)
        self.spans = Spans()
        self.recording = False
        #: a record a wave of the window: its end (s from the window's
        #: start), its size, and what the timed path produced for the
        #: requests kept for judging (tickets, embeddings, k-th
        #: similarities, results)
        self.waves = []
        self._cur = None

    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------
    def setup(self):
        from repro_torch.core.dataset import RoutingDataset
        from repro_torch.core.routers import make_router
        from repro_torch.serving.router_service import RouterService
        from repro_torch.serving.scheduler import MicroBatcher

        plain.no_tf32()
        cfg, e, dev = self.cfg, self.cfg["encoder"], self.dev
        g = torch.Generator(device=dev).manual_seed(
            common.sub_seed(self.seed, "encoder"))
        self.enc_w = plain.make_weights(self.ref.encoder_specs(e), g, dev)
        with self.spans.span("setup.support"):
            self.X, self.S, self.C = self._support()
        n = len(self.X)
        ds = RoutingDataset("bench-support", self.X, self.S, self.C,
                            list(cfg["pool"]), train_idx=np.arange(n),
                            val_idx=np.zeros(0, np.int64),
                            test_idx=np.zeros(0, np.int64))
        with self.spans.span("setup.engines"):
            engines = self._engines()
        router = make_router(cfg["spec"], device=str(dev))
        if router.k != cfg["k"] or router.weights != cfg["weights"] \
                or router.index != cfg["index"]:
            raise ValueError(f"spec {cfg['spec']!r} is not the configuration "
                             f"(k {cfg['k']}, {cfg['weights']}, "
                             f"{cfg['index']})")
        with self.spans.span("setup.fit"):
            self.svc = RouterService(router, engines, ds=ds,
                                     encoder=self._encoder())
        self.batcher = MicroBatcher(self.svc,
                                    max_batch=int(self.tp["max_batch"]))
        self._wrap()
        pool = int(self.tp["text_pool"])
        self.texts, _ = T.make_texts(self.tp, pool, self.seed, "requests")
        self.lams = T.lambdas(self.tp, pool, self.seed, "requests")
        with self.spans.span("setup.warm"):
            self._warm()

    def _support(self):
        """(X, S, C) host arrays: ``support_rows`` unit rows, paraphrases of
        ``prototypes`` texts of the mix, and each model's score and cost."""
        cfg, e, dev = self.cfg, self.cfg["encoder"], self.dev
        n_proto, N = int(cfg["prototypes"]), int(cfg["support_rows"])
        texts, topics = T.make_texts(self.tp, n_proto, self.seed,
                                     "prototypes")
        toks = self.ref.tokenize(texts, e["vocab_size"], e["max_positions"])
        P = self.ref.embed(self.enc_w, e, toks, dev, plain.Precision())
        D = P.shape[1]
        gs = torch.Generator(device=dev).manual_seed(
            common.sub_seed(self.seed, "support"))
        owner = torch.arange(N, device=dev) % n_proto
        X = torch.randn((N, D), generator=gs, device=dev)
        X.mul_(float(cfg["paraphrase_noise"]) / D ** 0.5).add_(P[owner])
        X.div_(X.norm(dim=1, keepdim=True))
        Xh = X.cpu().numpy()
        del X, P
        rng = np.random.default_rng(common.sub_seed(self.seed, "scores"))
        M = len(cfg["pool"])
        lo, hi = cfg["affinity"]
        aff = rng.uniform(lo, hi, (int(self.tp["topics"]), M))
        topic = topics[np.arange(N) % n_proto]
        S = np.clip(aff[topic] + rng.normal(0, cfg["score_noise"], (N, M)),
                    0, 1).astype(np.float32)
        clo, chi = cfg["cost_range"]
        C = np.tile(rng.uniform(clo, chi, M), (N, 1)).astype(np.float32)
        return Xh, S, C

    def _encoder(self):
        from repro_torch.models import model as M
        from repro_torch.serving.encoder import ENCODER_CFG, QueryEncoder
        e = self.cfg["encoder"]
        for key, val in (("n_layers", "num_hidden_layers"),
                         ("d_model", "hidden_size"),
                         ("n_heads", "num_attention_heads"),
                         ("n_kv_heads", "num_key_value_heads"),
                         ("head_dim", "head_dim"),
                         ("d_ff", "intermediate_size"),
                         ("vocab_size", "vocab_size")):
            if getattr(ENCODER_CFG, key) != e[val]:
                raise ValueError(f"the port's encoder has {key} "
                                 f"{getattr(ENCODER_CFG, key)}, the "
                                 f"configuration {e[val]}")
        lm = M.LM(ENCODER_CFG, self.dev)
        load_weights(lm, self.enc_w)
        return QueryEncoder(params=lm, device=self.dev)

    def _engines(self):
        """The idle pool at its published widths, its weights drawn on the
        card from the seed (routing is what the cell times)."""
        from repro_torch.configs import get_config, reduced
        from repro_torch.models import model as M
        from repro_torch.serving.engine import ServingEngine
        g = torch.Generator(device=self.dev).manual_seed(
            common.sub_seed(self.seed, "pool"))
        engines = {}
        for name in self.cfg["pool"]:
            pcfg = get_config(name)
            if self.cfg.get("pool_reduced"):
                pcfg = reduced(pcfg)
            lm = M.LM(pcfg, self.dev)
            with torch.no_grad():
                for p in lm.parameters():
                    p.normal_(0.0, 0.02, generator=g)
            engines[name] = ServingEngine(pcfg, params=lm, max_slots=1,
                                          cache_len=16, device=self.dev)
        return engines

    def _wrap(self):
        """Spans around the calls into the encoder and the router, and the
        record of what each wave's call returned."""
        enc, router = self.svc.encoder, self.svc.router
        embed_texts, serve_fused = enc.embed_texts, router.serve_fused

        def embed(texts):
            with self.spans.span("encoder"):
                out = embed_texts(texts)
            if self.recording:
                self._cur["emb"] = out
            return out

        def serve(X, lam, *a, **kw):
            with self.spans.span("router"):
                out = serve_fused(X, lam, *a, **kw)
            if self.recording:
                self._cur["kth"] = out[3]
                self._cur["q"] = len(X)
            return out

        enc.embed_texts = embed
        router.serve_fused = serve

    def _warm(self):
        """Every wave size the mix can flush: a full wave for a backlog,
        1 to ``max_batch`` for an open loop."""
        B = int(self.tp["max_batch"])
        sizes = [B, B] if self.tp["kind"] == "route_backlog" \
            else list(range(1, B + 1))
        for q in sizes:
            self._wave_of(q)
        self._sync()

    def _wave_of(self, q):
        """A wave of ``q`` requests outside the window, its results
        claimed and dropped."""
        tickets = [self.batcher.submit(self.texts[i], float(self.lams[i]))
                   for i in range(q)]
        self.batcher.flush()
        for tk in tickets:
            self.batcher.pop_result(tk)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------------
    # the window
    # ------------------------------------------------------------------
    def warm_once(self):
        """One wave of the cell's own size, for the profiler's warm-up."""
        self._wave_of(int(self.tp["max_batch"]) if
                      self.tp["kind"] == "route_backlog" else 1)
        self._sync()

    def run_window(self, seconds: float) -> dict:
        self.spans.ms.clear()
        self.c0 = (self.batcher.flushes, self.batcher.routed)
        self.waves, self.answered, self.done_at = [], 0, None
        self._judging()
        self.recording = True
        if self.tp["kind"] == "route_backlog":
            out = self._backlog(seconds)
        else:
            out = self._open(seconds)
        self.recording = False
        return out

    def _flush(self, pending: collections.deque, t0: float):
        """Flush one wave (the batcher routes its ``max_batch`` oldest
        requests), claim every result by its ticket, and keep what the
        judged requests got (`_keep`); the rest is dropped at once, so the
        window holds no more of the port's objects than a client would."""
        self._cur = {}
        with self.spans.span("wave"):
            self.batcher.flush()
        t = time.perf_counter() - t0
        q = min(int(self.tp["max_batch"]), len(pending))
        tickets = [pending.popleft() for _ in range(q)]
        results = [self.batcher.pop_result(tk) for tk in tickets]
        self.answered += sum(r is not None for r in results)
        emb, kth = self._cur.get("emb"), self._cur.get("kth")
        pos = [p for p, tk in enumerate(tickets) if self._keep(self.req[tk])]
        self.waves.append({
            "t": t, "q": self._cur.get("q", 0),
            "tickets": [tickets[p] for p in pos],
            "results": [results[p] for p in pos],
            "emb": None if emb is None else np.asarray(emb)[pos].copy(),
            "kth": None if kth is None else np.asarray(kth)[pos].copy()})
        if self.done_at is not None:
            for tk, r in zip(tickets, results):
                if r is not None:
                    self.done_at[self.req[tk]] = t
        return t

    def _judging(self):
        """Which requests are judged: each request number with
        probability ``check_share``, drawn from the seed, and the first
        request of each of the ``check_longest`` longest texts."""
        rng = np.random.default_rng(common.sub_seed(self.seed, "sample"))
        self._flags = rng.random(1 << 20) < float(self.tp["check_share"])
        n = int(self.tp.get("check_longest", 16))
        self._longest = set(np.argsort([-len(t.split()) for t in self.texts],
                                       kind="stable")[:n].tolist())

    def _keep(self, r: int) -> bool:
        i = r % len(self.texts)
        if i in self._longest:
            self._longest.discard(i)
            return True
        return bool(self._flags[r % len(self._flags)])

    def _backlog(self, seconds):
        B = int(self.tp["max_batch"])
        pool = len(self.texts)
        self.req = {}                # ticket -> request number
        pending = collections.deque()
        t0 = time.perf_counter()
        t = 0.0
        while t < seconds:
            with self.spans.span("refill"):
                while len(pending) < B:
                    r = len(self.req)
                    tk = self.batcher.submit(self.texts[r % pool],
                                             float(self.lams[r % pool]))
                    self.req[tk] = r
                    pending.append(tk)
            t = self._flush(pending, t0)
        self.window_s = t
        self.attempted = len(self.req)
        self.failed = self.attempted - self.answered
        return {"routes_per_s": self.answered / t}

    def _open(self, seconds):
        due = T.arrivals(self.tp, seconds, self.seed)
        pool = len(self.texts)
        n = len(due)
        self.req = {}
        self.due = due
        pending = collections.deque()
        self.done_at = done_at = np.full(n, np.nan)
        t0 = time.perf_counter()
        i = 0
        cap = seconds + float(self.tp.get("drain_s", 60.0))
        self.lag_s = 0.0
        while True:
            now = time.perf_counter() - t0
            while i < n and due[i] <= now:
                tk = self.batcher.submit(self.texts[i % pool],
                                         float(self.lams[i % pool]))
                self.req[tk] = i
                pending.append(tk)
                self.lag_s = max(self.lag_s, now - due[i])
                i += 1
            if pending:
                self._flush(pending, t0)
            elif i < n:
                wait = due[i] - now
                if wait > 2e-4:
                    time.sleep(wait - 1e-4)
            else:
                break
            if now > cap:
                break
        self.window_s = max(seconds, now)
        self.attempted = n
        lat = (done_at - due) * 1e3
        self.failed = int(np.isnan(lat).sum())
        # a request never answered counts as missing any latency limit
        lat = np.where(np.isnan(lat), np.inf, lat)
        self.latency_ms = lat
        return {"route_p95_ms": float(np.percentile(lat, 95))}

    # ------------------------------------------------------------------
    # after the window
    # ------------------------------------------------------------------
    def layer_context(self, trace) -> dict:
        return {"kind": self.tp["kind"], "spans": self.spans,
                "trace": trace, "window_s": self.window_s,
                "flushes": self.batcher.flushes - self.c0[0],
                "routed": self.batcher.routed - self.c0[1],
                "wave_q": [w["q"] for w in self.waves],
                "cfg": self.cfg, "support_rows": len(self.X)}

    def release(self):
        """Free the port's state, so that the reference fits beside what is
        left and the program's peak is read alone."""
        self.svc = self.batcher = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def program_answers(self) -> dict:
        """What the timed path produced for the judged requests."""
        names = list(self.cfg["pool"])
        out = collections.defaultdict(list)
        D = int(self.cfg["embed_dim"])
        for w in self.waves:
            for p, (tk, r) in enumerate(zip(w["tickets"], w["results"])):
                out["request"].append(self.req[tk])
                out["answered"].append(r is not None)
                out["emb"].append(w["emb"][p] if w["emb"] is not None
                                  else np.full(D, np.nan))
                out["kth"].append(w["kth"][p] if w["kth"] is not None
                                  else np.nan)
                if r is None:
                    for key in ("s_hat", "c_hat"):
                        out[key].append(np.full(len(names), np.nan))
                    out["agree"].append(np.nan)
                    out["choice"].append(-1)
                    out["lam"].append(np.nan)
                    continue
                out["s_hat"].append(np.asarray(r.s_row, np.float64))
                out["c_hat"].append(np.asarray(r.c_row, np.float64))
                out["agree"].append(r.confidence)
                out["choice"].append(names.index(r.model))
                out["lam"].append(r.lam)
        return {k: np.asarray(v) for k, v in out.items()}

    def reference_answers(self, requests, precision="f32") -> dict:
        """The plain reference on the requests' texts and lambdas."""
        pr = plain.Precision(precision)
        e, dev, k = self.cfg["encoder"], self.dev, int(self.cfg["k"])
        pool = len(self.texts)
        texts = [self.texts[r % pool] for r in requests]
        lam = torch.as_tensor(
            np.asarray([self.lams[r % pool] for r in requests], np.float32),
            device=dev)
        toks = self.ref.tokenize(texts, e["vocab_size"], e["max_positions"])
        emb = self.ref.embed(self.enc_w, e, toks, dev, pr)
        sims, idx = self.ref.topk(emb, self.X, k, pr)
        S = torch.from_numpy(self.S).to(dev)
        C = torch.from_numpy(self.C).to(dev)
        choice, s_hat, c_hat, agree, util = self.ref.tail(idx[:, :k], S, C,
                                                          lam)
        top2 = torch.topk(util, min(2, util.shape[1]), dim=1).values
        return {"emb": emb.cpu().numpy(), "kth": sims[:, k - 1].cpu().numpy(),
                "margin": (sims[:, k - 1] - sims[:, k]).cpu().numpy()
                if sims.shape[1] > k else np.full(len(texts), np.inf),
                "s_hat": s_hat.cpu().numpy(), "c_hat": c_hat.cpu().numpy(),
                "agree": agree.cpu().numpy(), "choice": choice.cpu().numpy(),
                "util_margin": (top2[:, 0] - top2[:, -1]).cpu().numpy(),
                "lam": lam.cpu().numpy()}

    def readings(self, ans: dict, ref: dict, lim: dict) -> dict:
        """The numbers compared, of ``ans`` (the program's answers, or the
        control's) against the reference's."""
        ok = ans["answered"].astype(bool)
        tie = float(lim.get("tie_margin", 1e-5))
        clear = ok & (ref["margin"] > tie)
        decided = clear & (ref["util_margin"] > float(
            lim.get("util_tie", 1e-6)))

        def gap(a, b, mask):
            if not mask.any():
                return 0.0
            return float(np.max(np.abs(np.asarray(a, np.float64)[mask]
                                       - np.asarray(b, np.float64)[mask])))
        return {
            "emb_gap": gap(ans["emb"], ref["emb"], ok),
            "kth_gap": gap(ans["kth"], ref["kth"], ok),
            "util_gap": max(gap(ans["s_hat"], ref["s_hat"], clear),
                            gap(ans["c_hat"], ref["c_hat"], clear)),
            "agree_gap": gap(ans["agree"], ref["agree"], clear),
            "choice_mismatch": int((ans["choice"][decided]
                                    != ref["choice"][decided]).sum()),
            "lam_mismatch": int((ans["lam"][ok] != ref["lam"][ok]).sum()),
            "unanswered": int(self.failed + (~ok).sum()),
            "judged": int(len(ok)),
            "clear_share": float(clear.mean()) if len(ok) else 0.0,
        }

    def check(self, lim: dict) -> dict:
        ans = self.program_answers()
        ref = self.reference_answers(ans["request"])
        self._judged = (ans, ref)
        return self.readings(ans, ref, lim)

    def control(self, lim: dict) -> dict:
        """The reference put in the program's place in TF32, the step below
        the configuration's float32, judged as the program is."""
        ans, ref = self._judged
        low = self.reference_answers(ans["request"], precision="tf32")
        low["answered"] = ans["answered"]
        return self.readings(low, ref, lim)


def load_weights(lm, weights: dict):
    """Copy the benchmark's weights into the port's parameters, by name;
    every parameter must be named, at its shape."""
    params = dict(lm.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights and the port's parameters differ: "
                         f"{sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            w = weights[name]
            if tuple(p.shape) != tuple(w.shape):
                raise ValueError(f"{name}: the port's {tuple(p.shape)}, the "
                                 f"benchmark's {tuple(w.shape)}")
            p.copy_(w)
