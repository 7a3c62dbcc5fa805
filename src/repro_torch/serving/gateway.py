"""OpenAI-compatible streaming routing gateway of the port (mirrors
`repro.serving.gateway`): the serving stack's network front door,
stdlib-only (asyncio; no aiohttp/uvicorn/fastapi).

The requested **model name is the router address**: ``repro/<spec>`` where
``<spec>`` is the router-spec grammar (`repro_torch.core.routers.spec`),
so the per-request cost threshold rides in the name like RouteLLM's
``router-bert-0.5`` addressing::

    {"model": "repro/knn100-ivfpq@lam=0.35", "stream": true,
     "messages": [{"role": "user", "content": "algebra proofs question"}]}

The base spec (family / k / index backend) must match the router this
gateway serves (a running index cannot be reconfigured per request), and
the only per-request key is ``lam``, which becomes that request's
cost/quality trade-off in the selection.  Bad names are a structured 400,
never a traceback.

Request path (no per-request route anywhere):

  HTTP handler -> `MicroBatcher.submit` (bounded queue; `Overloaded` maps
  to **429 + Retry-After**) -> the pump thread closes the wave by the
  wave-close rule and ``flush()``es it through `RouterService.route_fused`
  (one route of the whole wave on the card, per-request lambdas kept) ->
  `RouterService.execute` decodes on the chosen engines with breakers,
  reroutes and deadlines, streaming each token back through
  `Request.on_token` -> the handler writes SSE ``chat.completion.chunk``
  frames as the tokens land.

Endpoints::

    POST /v1/chat/completions   OpenAI chat completions (SSE when stream)
    GET  /v1/models             the one routable model name
    GET  /health                200 all breakers closed / 503 degraded
    GET  /health/live           200 while the event loop serves
    GET  /stats                 RouterService.stats() + gateway counters
                                + `tracing.summary()` (spans and counters
                                recorded while tracing is on)

Failure mapping: `Overloaded` -> 429 with ``Retry-After``; a request that
lands in ``ExecutionReport.failed`` (attempt budget / candidate pool
exhausted) -> **502** carrying the attempt trace (models tried, typed
reason); handler bugs -> 500 with the exception type only.  A client
disconnect cancels the request cooperatively: a still-queued ticket leaves
the batcher (freeing its admission slot), an in-flight one sets
``Request.cancelled`` and the engine frees the decode slot at the next
wave.

Every completion emits ONE structured timing log line (JSON on the
``repro_torch.serving.gateway`` logger) with per-stage latencies:
``queue_wait`` (arrival -> admission), ``wave_close`` (admission -> wave
flush), ``route`` (the wave's route), ``first_token`` (arrival -> first
streamed token, i.e. TTFT) and ``stream`` (first -> last token); `/stats`
aggregates recent TTFT p50/p99.

Boot (reduced-config pool, synthetic support set)::

    PYTHONPATH=src python -m repro_torch.serving.gateway --port 8800
    PYTHONPATH=src python -m repro_torch.serving.gateway --device cpu
    curl -N localhost:8800/v1/chat/completions -d '{...}'

The engines, the encoder and the router live on ``--device`` (the card by
default; ``cpu`` runs the kernels' plain versions).  ``--state-dir DIR``
makes the service durable: observe() batches are write-ahead-logged and
checkpointed under DIR, a drain writes a final checkpoint, and a DIR that
already holds a checkpoint boots through `RouterService.recover` (readiness
answers 503 "starting" while a replay is pending) instead of refitting.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import json
import logging
import math
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch import tracing
from repro_torch.core.routers.spec import RouterSpec, format_spec, parse_spec
from .faults import DegradationLadder, Overloaded
from .router_service import RouterService, to_jsonable
from .scheduler import MicroBatcher

log = logging.getLogger("repro_torch.serving.gateway")

#: model names served by a repro gateway are ``repro/<router-spec>``
MODEL_PREFIX = "repro/"

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            502: "Bad Gateway", 503: "Service Unavailable",
            504: "Gateway Timeout"}

_MAX_BODY_BYTES = 1 << 20


class GatewayError(Exception):
    """A structured HTTP error response.  ``body()`` is the OpenAI-style
    error envelope — the response body never carries a traceback."""

    def __init__(self, status: int, code: str, message: str, *,
                 retry_after_s: Optional[float] = None,
                 detail: Optional[Dict] = None):
        super().__init__(message)
        self.status = int(status)
        self.code = code
        self.message = message
        self.retry_after_s = retry_after_s
        self.detail = detail or {}

    @property
    def error_type(self) -> str:
        if self.status == 429:
            return "overloaded_error"
        return "server_error" if self.status >= 500 else \
            "invalid_request_error"

    def body(self) -> Dict:
        err = {"message": self.message, "type": self.error_type,
               "code": self.code}
        if self.retry_after_s is not None:
            err["retry_after_s"] = round(float(self.retry_after_s), 4)
        err.update(self.detail)
        return {"error": err}


def parse_model_name(name, service) -> Optional[float]:
    """Resolve an OpenAI ``model`` field against the served router.

    Returns the per-request lambda from the name's ``@lam=`` key (None =
    service default).  Raises `GatewayError` (status 400) on a missing
    ``repro/`` prefix, an unparseable spec, a base spec (family / k /
    backend) other than the one this gateway serves, a non-numeric lambda,
    or any other per-request kwarg — a fitted index cannot be
    reconfigured per request."""
    if not isinstance(name, str) or not name.strip():
        raise GatewayError(400, "model_missing",
                           "request must carry a non-empty 'model' string, "
                           f"e.g. '{MODEL_PREFIX}{service.spec}@lam=0.35'")
    if not name.startswith(MODEL_PREFIX):
        raise GatewayError(
            400, "model_prefix",
            f"model {name!r} must be addressed as "
            f"'{MODEL_PREFIX}<router-spec>' (this gateway serves "
            f"'{MODEL_PREFIX}{service.spec}')")
    raw = name[len(MODEL_PREFIX):]
    if raw == service.spec:
        # a client echoing the advertised model id verbatim (/v1/models)
        # must always resolve, even when the served spec itself carries
        # ctor kwargs (e.g. an online router's '@online=1,delta_cap=...')
        return None
    try:
        spec = parse_spec(raw)
    except ValueError as exc:
        raise GatewayError(400, "bad_spec",
                           f"unparseable router spec {raw!r}: {exc}")
    served = parse_spec(service.spec)
    base = (spec.family, spec.k, spec.ivf, spec.pq)
    if base != (served.family, served.k, served.ivf, served.pq):
        req_base = format_spec(RouterSpec(spec.family, k=spec.k,
                                          ivf=spec.ivf, pq=spec.pq))
        raise GatewayError(
            400, "wrong_router",
            f"this gateway serves '{MODEL_PREFIX}{service.spec}', not "
            f"{req_base!r} — only '@lam=' may vary per request")
    extra = sorted(k for k in spec.kwargs if k != "lam")
    if extra:
        raise GatewayError(
            400, "immutable_router",
            f"per-request model kwargs {extra} cannot reconfigure a "
            f"running router; only '@lam=' varies per request")
    lam = spec.kwargs.get("lam")
    if lam is None:
        return None
    if isinstance(lam, bool) or not isinstance(lam, (int, float)):
        raise GatewayError(400, "bad_lam",
                           f"'@lam=' must be numeric, got {lam!r}")
    return float(lam)


def _prompt_from_messages(messages) -> str:
    """Flatten an OpenAI ``messages`` list into the routed prompt text."""
    if not isinstance(messages, list) or not messages:
        raise GatewayError(400, "messages_missing",
                           "'messages' must be a non-empty list of "
                           "{role, content} objects")
    parts = []
    for i, m in enumerate(messages):
        if (not isinstance(m, dict) or not isinstance(m.get("role"), str)
                or not isinstance(m.get("content"), str)):
            raise GatewayError(400, "bad_message",
                               f"messages[{i}] must be an object with "
                               f"string 'role' and string 'content'")
        parts.append(m["content"])
    prompt = "\n".join(p for p in parts if p).strip()
    if not prompt:
        raise GatewayError(400, "empty_prompt",
                           "messages carry no non-empty content")
    return prompt


def _token_text(tok: int) -> str:
    """Detokenization stand-in: the pool engines emit raw token ids (the
    repo has no real detokenizer), rendered as decimal + space so streams
    are well-formed text and deterministic."""
    return f"{tok} "


def _percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    xs = sorted(values)
    idx = min(int(math.ceil(q / 100.0 * len(xs))) - 1, len(xs) - 1)
    return xs[max(idx, 0)]


@dataclasses.dataclass
class _Pending:
    """One in-flight HTTP completion: the bridge between the pump thread
    (routing + decode) and the asyncio handler streaming the response."""
    loop: asyncio.AbstractEventLoop
    queue: asyncio.Queue
    model_name: str
    max_new_tokens: int
    stream: bool
    t_arrival: float
    ticket: int = -1
    t_submit: float = 0.0
    t_flush_start: float = 0.0
    t_routed: float = 0.0
    t_first_token: float = 0.0
    t_last_token: float = 0.0
    tokens: int = 0
    routed: bool = False
    cancelled: bool = False
    result: object = None        # RoutedResult once the wave flushed

    def push(self, kind: str, payload=None) -> None:
        """Thread-safe event delivery into the handler's queue."""
        try:
            self.loop.call_soon_threadsafe(self.queue.put_nowait,
                                           (kind, payload))
        except RuntimeError as exc:
            # loop already closed (shutdown race) — the handler is gone,
            # nobody is waiting on this event
            log.debug("event %s dropped, handler loop closed: %s",
                      kind, exc)

    def on_token(self, tok: int) -> None:
        now = time.perf_counter()
        if self.tokens == 0:
            self.t_first_token = now
        self.t_last_token = now
        self.tokens += 1
        self.push("token", int(tok))

    def timing(self, now: Optional[float] = None) -> Dict[str, float]:
        """Per-stage latencies (seconds) — the structured log payload."""
        now = time.perf_counter() if now is None else now
        t = {"total_s": now - self.t_arrival}
        if self.t_submit:
            t["queue_wait_s"] = self.t_submit - self.t_arrival
        if self.t_flush_start and self.t_submit:
            t["wave_close_s"] = self.t_flush_start - self.t_submit
        if self.t_routed and self.t_flush_start:
            t["route_s"] = self.t_routed - self.t_flush_start
        if self.t_first_token:
            t["first_token_s"] = self.t_first_token - self.t_arrival
        if self.t_last_token and self.t_first_token:
            t["stream_s"] = self.t_last_token - self.t_first_token
        return {k: round(v, 6) for k, v in t.items()}


class Gateway:
    """The HTTP front end over one `RouterService`.

    Two worker threads around the asyncio server:

    * ``gateway-http`` runs the asyncio event loop (socket accept, request
      parsing, SSE writing); it never runs a torch op;
    * ``gateway-pump`` owns the `MicroBatcher`: it closes routing waves by
      the wave-close rule, rides `route_fused` (one route a wave), then
      `RouterService.execute`s the wave with per-token streaming
      callbacks.  Grad mode is per thread, so the calls it makes build no
      autograd graph by themselves (`serve_fused`, the encoder and
      `decode_step` run under ``torch.no_grad``).  `Request.on_token` fires
      on the pump thread (or on the engine's deadline worker) and hands
      each frame to the event loop with ``call_soon_threadsafe``.  Routing
      and decode therefore serialize into waves; arrivals during a wave
      queue in the bounded batcher and shed with 429 past
      ``max_pending`` — backpressure, never a silent drop.

    ``max_batch`` / ``close_timeout_s`` left at None adopt the service's
    fitted `DispatchPolicy` wave constants (`MicroBatcher.from_policy`)
    with static fallbacks."""

    def __init__(self, service: RouterService, *, host: str = "127.0.0.1",
                 port: int = 0, max_batch: Optional[int] = None,
                 close_timeout_s: Optional[float] = None,
                 max_pending: int = 64,
                 default_max_new_tokens: int = 16,
                 max_new_tokens_cap: int = 64,
                 request_timeout_s: float = 120.0,
                 deadline_s: Optional[float] = None,
                 ladder: Optional[DegradationLadder] = None,
                 poll_interval_s: float = 0.002):
        self.service = service
        self.host = host
        self._requested_port = int(port)
        self.port: Optional[int] = None
        self.model_name = MODEL_PREFIX + service.spec
        self.max_new_tokens_cap = int(max_new_tokens_cap)
        self.default_max_new_tokens = min(int(default_max_new_tokens),
                                          self.max_new_tokens_cap)
        self.request_timeout_s = float(request_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        overrides: Dict = {"max_pending": int(max_pending)}
        if max_batch is not None:
            overrides["max_batch"] = int(max_batch)
        if close_timeout_s is not None:
            overrides["close_timeout_s"] = float(close_timeout_s)
        if deadline_s is not None:
            overrides["deadline_s"] = float(deadline_s)
        if ladder is not None:
            overrides["ladder"] = ladder
        self.batcher = MicroBatcher.from_policy(
            service, max_new_tokens=self.default_max_new_tokens, **overrides)
        if self.batcher.max_batch == 64 and max_batch is None \
                and getattr(service, "dispatch_policy", None) is None:
            self.batcher.max_batch = 8          # demo-scale static default
        if self.batcher.close_timeout_s is None:
            self.batcher.close_timeout_s = 0.01

        self._lock = threading.Lock()       # guards batcher + _pending
        self._pending: Dict[int, _Pending] = {}
        #: SIGTERM graceful-drain flag: admissions answer 503 "draining"
        #: (and /health readiness flips) while in-flight waves finish
        self._draining = False
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._started = threading.Event()
        self._closed = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        self._http_thread: Optional[threading.Thread] = None
        self._pump_thread: Optional[threading.Thread] = None
        self._boot_error: Optional[BaseException] = None
        self._next_id = 0
        self.counters = collections.Counter()
        self._ttfts: collections.deque = collections.deque(maxlen=512)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "Gateway":
        """Bind the listening socket (ephemeral port resolved here), start
        the HTTP loop and pump threads.  Returns self."""
        self._http_thread = threading.Thread(
            target=self._run_http_loop, daemon=True, name="gateway-http")
        self._http_thread.start()
        self._started.wait(timeout=30.0)
        if self._boot_error is not None:
            raise RuntimeError("gateway failed to boot") from self._boot_error
        if self.port is None:
            raise RuntimeError("gateway HTTP loop did not come up in 30s")
        self._pump_thread = threading.Thread(
            target=self._pump, daemon=True, name="gateway-pump")
        self._pump_thread.start()
        log.info("gateway listening on http://%s:%d serving %s",
                 self.host, self.port, self.model_name)
        return self

    def close(self) -> None:
        """Clean shutdown: stop admitting, join the pump mid-wave, resolve
        every still-pending handler with a typed shutdown error (never a
        silent drop), drain the batcher, stop the HTTP loop, and close the
        service.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._wake.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=60.0)
        with self._lock:
            leftovers = list(self._pending.values())
            self._pending.clear()
        for h in leftovers:
            h.push("failed", {"code": "gateway_shutdown",
                              "message": "gateway is shutting down",
                              "status": 503, "attempts": []})
        self.batcher.close()
        if self._loop is not None and self.port is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._http_thread is not None:
            self._http_thread.join(timeout=30.0)
        self.service.close()

    def begin_drain(self) -> None:
        """Flip into draining: new submissions (and /health readiness) get
        503 "draining" immediately; waves already admitted keep running."""
        self._draining = True

    def drain(self, timeout_s: float = 60.0) -> None:
        """SIGTERM graceful shutdown: stop admissions, let the in-flight
        waves resolve (bounded by ``timeout_s``), write a final durability
        checkpoint (a durable service), then take the port dark
        (`close`)."""
        self.begin_drain()
        log.info("draining: admissions stopped, waiting for in-flight waves")
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            with self._lock:
                idle = not self._pending and self.batcher.pending() == 0
            if idle:
                break
            time.sleep(max(self.poll_interval_s, 0.002))
        # give just-resolved handlers one beat to flush their last bytes
        # before the event loop stops
        time.sleep(5 * self.poll_interval_s)
        try:
            path = self.service.checkpoint()
            if path is not None:
                log.info("final checkpoint written to %s", path)
        except Exception:
            log.exception("final checkpoint failed during drain")
        self.close()
        log.info("drain complete, port dark")

    def install_signal_handlers(self, signums=(signal.SIGTERM,),
                                drain_timeout_s: float = 60.0) -> Dict:
        """Route SIGTERM to `drain` with ``drain_timeout_s`` (on a worker
        thread: handlers run on the main thread, and drain blocks).
        Returns {signum: previous handler} so tests can restore."""
        prev = {}

        def _handler(signum, frame):
            log.info("signal %d received, starting graceful drain", signum)
            threading.Thread(target=self.drain, args=(drain_timeout_s,),
                             name="gateway-drain", daemon=True).start()

        for s in signums:
            prev[s] = signal.signal(s, _handler)
        return prev

    def __enter__(self) -> "Gateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # pump thread: wave close -> fused route -> execute (token streaming)
    # ------------------------------------------------------------------
    def _claim_wave(self) -> List[_Pending]:
        """Flush the batcher when its wave-close rule fires and claim the
        routed results for their pending handlers.  Runs under the lock:
        a flush is one route, so concurrent submits wait at most one
        route, which is the wave semantics."""
        wave: List[_Pending] = []
        with self._lock:
            if not self.batcher.ready():
                return wave
            t0 = time.perf_counter()
            self.batcher.flush()
            t1 = time.perf_counter()
            for ticket, h in list(self._pending.items()):
                if h.routed:
                    continue
                r = self.batcher.pop_result(ticket)
                if r is None:
                    continue                    # still queued for next wave
                h.routed, h.result = True, r
                h.t_flush_start, h.t_routed = t0, t1
                if h.cancelled:                 # client left before routing
                    r.request.cancelled = True
                    del self._pending[ticket]
                    continue
                r.request.max_new_tokens = min(h.max_new_tokens,
                                               self.max_new_tokens_cap)
                r.request.on_token = h.on_token
                h.push("routed", r.model)
                wave.append(h)
        return wave

    def _pump(self) -> None:
        while not self._stop.is_set():
            wave = self._claim_wave()
            if not wave:
                self._wake.wait(self.poll_interval_s)
                self._wake.clear()
                continue
            results = [h.result for h in wave]
            try:
                report = self.service.execute(results)
            except Exception as exc:
                log.exception("execute() failed for a %d-request wave",
                              len(wave))
                with self._lock:
                    for h in wave:
                        self._pending.pop(h.ticket, None)
                for h in wave:
                    h.push("failed", {
                        "code": "execute_error", "status": 502,
                        "message": f"{type(exc).__name__}: {exc}",
                        "attempts": [h.result.model]})
                continue
            with self._lock:
                for h in wave:
                    self._pending.pop(h.ticket, None)
            for h in wave:
                r = h.result
                reason = report.failed.get(r.uid)
                if reason is None and r.request.error \
                        and r.request.error != "cancelled":
                    reason = r.request.error
                if reason is not None:
                    self.counters["failed_502"] += 1
                    h.push("failed", {
                        "code": "routing_failed", "status": 502,
                        "message": reason,
                        "attempts": r.rerouted_from + [r.model],
                        "rerouted": len(r.rerouted_from)})
                else:
                    h.push("done", {
                        "served_by": r.model, "uid": r.uid,
                        "degradation": r.degradation,
                        "rerouted_from": list(r.rerouted_from),
                        "predicted_score": r.predicted_score,
                        "predicted_cost": r.predicted_cost,
                        "lam": r.lam})

    # ------------------------------------------------------------------
    # asyncio HTTP loop
    # ------------------------------------------------------------------
    def _run_http_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            server = loop.run_until_complete(asyncio.start_server(
                self._handle_conn, self.host, self._requested_port))
        except Exception as exc:
            self._boot_error = exc
            self._started.set()
            loop.close()
            raise
        self._server = server
        self.port = server.sockets[0].getsockname()[1]
        self._started.set()
        try:
            loop.run_forever()
        finally:
            server.close()
            loop.run_until_complete(server.wait_closed())
            tasks = [t for t in asyncio.all_tasks(loop) if not t.done()]
            for t in tasks:
                t.cancel()
            if tasks:
                loop.run_until_complete(
                    asyncio.gather(*tasks, return_exceptions=True))
            loop.close()

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            parsed = await self._read_request(reader)
            if parsed is None:
                return
            method, path, headers, body = parsed
            self.counters["requests"] += 1
            if path == "/v1/chat/completions":
                if method != "POST":
                    raise GatewayError(405, "method_not_allowed",
                                       f"{method} not allowed on {path}")
                await self._chat(reader, writer, body)
            elif path == "/health":
                await self._health(writer, method)
            elif path == "/health/live":
                await self._live(writer, method)
            elif path == "/stats":
                await self._stats(writer, method)
            elif path == "/v1/models":
                await self._models(writer, method)
            else:
                raise GatewayError(404, "not_found",
                                   f"no route for {path!r}")
        except GatewayError as exc:
            if 400 <= exc.status < 500:
                self.counters["errors_4xx"] += 1
            else:
                self.counters["errors_5xx"] += 1
            await self._send_error(writer, exc)
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError) as exc:
            log.debug("client connection dropped: %s", exc)
        except Exception as exc:
            # never a traceback in the response body — type name only
            log.exception("unhandled gateway error")
            self.counters["errors_5xx"] += 1
            await self._send_error(writer, GatewayError(
                500, "internal_error",
                f"internal gateway error ({type(exc).__name__})"))
        finally:
            with contextlib.suppress(Exception):
                writer.close()

    @staticmethod
    async def _read_request(reader) -> Optional[Tuple[str, str, Dict, bytes]]:
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin1").strip().split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise GatewayError(400, "bad_request_line",
                               "malformed HTTP request line")
        method, target = parts[0].upper(), parts[1].split("?", 1)[0]
        headers: Dict[str, str] = {}
        while True:
            hl = await reader.readline()
            if hl in (b"\r\n", b"\n", b""):
                break
            key, _, val = hl.decode("latin1").partition(":")
            headers[key.strip().lower()] = val.strip()
        try:
            n = int(headers.get("content-length", "0") or "0")
        except ValueError:
            raise GatewayError(400, "bad_content_length",
                               "Content-Length is not an integer")
        if n > _MAX_BODY_BYTES:
            raise GatewayError(413, "payload_too_large",
                               f"body exceeds {_MAX_BODY_BYTES} bytes")
        body = await reader.readexactly(n) if n else b""
        return method, target, headers, body

    @staticmethod
    async def _write(writer, status: int, content_type: str, data: bytes,
                     extra_headers: Optional[Dict[str, str]] = None,
                     close: bool = True) -> None:
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
                f"Content-Type: {content_type}"]
        if close:
            head.append(f"Content-Length: {len(data)}")
        head.append("Connection: close")
        for k, v in (extra_headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
        await writer.drain()

    async def _send_json(self, writer, status: int, obj,
                         extra_headers=None) -> None:
        data = json.dumps(to_jsonable(obj)).encode()
        await self._write(writer, status, "application/json", data,
                          extra_headers)

    async def _send_error(self, writer, exc: GatewayError) -> None:
        headers = {}
        if exc.status == 429 and exc.retry_after_s is not None:
            headers["Retry-After"] = str(max(1, math.ceil(exc.retry_after_s)))
        with contextlib.suppress(ConnectionResetError, BrokenPipeError,
                                 RuntimeError):
            await self._send_json(writer, exc.status, exc.body(), headers)

    # ---- GET endpoints ----
    def _require_get(self, method: str, path: str) -> None:
        if method != "GET":
            raise GatewayError(405, "method_not_allowed",
                               f"{method} not allowed on {path}")

    def _readiness(self) -> Tuple[int, Dict]:
        """Readiness state machine: "starting" (503, recovery replay not
        finished) -> "ok"/"degraded" (breaker view) -> "draining" (503,
        SIGTERM received).  Liveness is a separate endpoint — a draining or
        replaying process is alive but must not receive traffic."""
        if self._draining or self._stop.is_set():
            return 503, {"status": "draining",
                         "in_flight": len(self._pending)}
        rec = self.service.recovery_status()
        if rec is not None and rec.get("status") == "replaying":
            return 503, {"status": "starting", "recovery": rec}
        st = self.service.stats()
        ok = all(st.get("available", {}).values())
        return 200 if ok else 503, {"status": "ok" if ok else "degraded",
                                    **st}

    async def _health(self, writer, method: str) -> None:
        self._require_get(method, "/health")
        status, payload = self._readiness()
        await self._send_json(writer, status, payload)

    async def _live(self, writer, method: str) -> None:
        """Liveness: 200 whenever the event loop serves — draining and
        recovery replay are READINESS failures, not liveness ones, so an
        orchestrator restarts only truly wedged processes."""
        self._require_get(method, "/health/live")
        await self._send_json(writer, 200, {"status": "alive"})

    async def _stats(self, writer, method: str) -> None:
        self._require_get(method, "/stats")
        ttfts = list(self._ttfts)
        with self._lock:
            batcher = {
                "pending": self.batcher.pending(),
                "flushes": self.batcher.flushes,
                "routed": self.batcher.routed,
                "shed": self.batcher.shed,
                "degraded_waves": self.batcher.degraded_waves,
                "max_batch": self.batcher.max_batch,
                "close_timeout_s": self.batcher.close_timeout_s,
                "max_pending": self.batcher.max_pending,
            }
            in_flight = len(self._pending)
        payload = {
            "model": self.model_name,
            "service": self.service.stats(),
            "gateway": {
                **{k: int(v) for k, v in sorted(self.counters.items())},
                "in_flight": in_flight,
                "draining": self._draining,
                "batcher": batcher,
                "ttft_p50_s": _percentile(ttfts, 50),
                "ttft_p99_s": _percentile(ttfts, 99),
                "ttft_window": len(ttfts),
            },
            "tracing": tracing.summary(),
        }
        await self._send_json(writer, 200, payload)

    async def _models(self, writer, method: str) -> None:
        self._require_get(method, "/v1/models")
        await self._send_json(writer, 200, {
            "object": "list",
            "data": [{"id": self.model_name, "object": "model",
                      "created": 0, "owned_by": "repro",
                      "root": self.service.spec}]})

    # ---- POST /v1/chat/completions ----
    def _submit(self, h: _Pending, prompt: str,
                lam: Optional[float]) -> None:
        rec = self.service.recovery_status()
        if rec is not None and rec.get("status") == "replaying":
            raise GatewayError(503, "starting",
                               "gateway is replaying its write-ahead log; "
                               "not ready for traffic yet",
                               detail={"recovery": rec})
        with self._lock:
            if self._stop.is_set():
                raise GatewayError(503, "shutting_down",
                                   "gateway is shutting down")
            if self._draining:
                raise GatewayError(503, "draining",
                                   "gateway is draining; not accepting new "
                                   "requests")
            try:
                h.ticket = self.batcher.submit(prompt, lam)
            except Overloaded as exc:
                self.counters["shed_429"] += 1
                raise GatewayError(
                    429, "overloaded", str(exc),
                    retry_after_s=exc.retry_after_s,
                    detail={"pending": exc.pending})
            h.t_submit = time.perf_counter()
            self._pending[h.ticket] = h
        self._wake.set()

    def _cancel(self, h: _Pending) -> None:
        """Client went away: release whatever the request still holds —
        its queued admission slot, or its decode slot via cooperative
        `Request.cancelled`."""
        with self._lock:
            self._pending.pop(h.ticket, None)
            h.cancelled = True
            still_queued = self.batcher.cancel(h.ticket)
        if not still_queued and h.result is not None:
            h.result.request.cancelled = True
        self.counters["cancelled"] += 1
        self._record(h, "cancelled")

    def _record(self, h: _Pending, status: str) -> None:
        timing = h.timing()
        if "first_token_s" in timing:
            self._ttfts.append(timing["first_token_s"])
        log.info("%s", json.dumps(to_jsonable({
            "event": "completion", "status": status,
            "model": h.model_name, "ticket": h.ticket,
            "stream": h.stream, "tokens": h.tokens, "timing": timing})))

    async def _next_event(self, h: _Pending, eof_task,
                          deadline: float) -> Tuple[str, object]:
        """Await the next pump event, a client EOF, or the deadline."""
        get = asyncio.ensure_future(h.queue.get())
        try:
            while True:
                timeout = deadline - h.loop.time()
                if timeout <= 0:
                    return "timeout", None
                waiters = {get} | ({eof_task} if eof_task is not None
                                   and not eof_task.done() else set())
                done, _ = await asyncio.wait(
                    waiters, timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED)
                if get in done:
                    return get.result()
                if eof_task is not None and eof_task.done():
                    if eof_task.cancelled() or not eof_task.result():
                        return "client_gone", None
                    eof_task = None       # stray bytes; keep waiting
                if not done:
                    return "timeout", None
        finally:
            if not get.done():
                get.cancel()

    async def _chat(self, reader, writer, body: bytes) -> None:
        try:
            payload = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            raise GatewayError(400, "bad_json",
                               "request body is not valid JSON")
        if not isinstance(payload, dict):
            raise GatewayError(400, "bad_json",
                               "request body must be a JSON object")
        lam = parse_model_name(payload.get("model"), self.service)
        prompt = _prompt_from_messages(payload.get("messages"))
        stream = bool(payload.get("stream", False))
        max_tokens = payload.get("max_tokens", self.default_max_new_tokens)
        if not isinstance(max_tokens, int) or isinstance(max_tokens, bool) \
                or max_tokens < 1:
            raise GatewayError(400, "bad_max_tokens",
                               "'max_tokens' must be a positive integer")
        loop = asyncio.get_running_loop()
        h = _Pending(loop=loop, queue=asyncio.Queue(),
                     model_name=str(payload.get("model")),
                     max_new_tokens=min(max_tokens, self.max_new_tokens_cap),
                     stream=stream, t_arrival=time.perf_counter())
        self._submit(h, prompt, lam)
        # EOF sentinel: a streaming client closing its socket is the
        # cancellation signal — readers at EOF resolve with b""
        eof_task = asyncio.ensure_future(reader.read(1))
        try:
            if stream:
                await self._stream_response(writer, h, eof_task)
            else:
                await self._unary_response(writer, h, eof_task)
        finally:
            if not eof_task.done():
                eof_task.cancel()

    def _chunk(self, cid: str, created: int, h: _Pending, delta: Dict,
               finish: Optional[str], extra: Optional[Dict] = None) -> bytes:
        obj = {"id": cid, "object": "chat.completion.chunk",
               "created": created, "model": h.model_name,
               "choices": [{"index": 0, "delta": delta,
                            "finish_reason": finish}]}
        if extra:
            obj["repro"] = to_jsonable(extra)
        return f"data: {json.dumps(obj)}\n\n".encode()

    async def _stream_response(self, writer, h: _Pending, eof_task) -> None:
        cid = f"chatcmpl-{h.ticket}"
        created = int(time.time())
        deadline = h.loop.time() + self.request_timeout_s
        headers_sent = False
        served_by = None
        try:
            while True:
                kind, payload = await self._next_event(h, eof_task, deadline)
                if kind == "routed":
                    served_by = payload
                    continue
                if kind == "token":
                    if not headers_sent:
                        # a reroute moved the request before its first
                        # token: the engine serving it is the result's now
                        served_by = h.result.model
                        await self._write(
                            writer, 200, "text/event-stream", b"",
                            {"Cache-Control": "no-cache",
                             "X-Repro-Served-By": str(served_by)},
                            close=False)
                        writer.write(self._chunk(
                            cid, created, h,
                            {"role": "assistant", "content": ""}, None))
                        headers_sent = True
                    writer.write(self._chunk(
                        cid, created, h,
                        {"content": _token_text(payload)}, None))
                    await writer.drain()
                    continue
                if kind == "done":
                    if not headers_sent:    # zero-token completion
                        served_by = (payload or {}).get("served_by",
                                                        served_by)
                        await self._write(
                            writer, 200, "text/event-stream", b"",
                            {"Cache-Control": "no-cache",
                             "X-Repro-Served-By": str(served_by)},
                            close=False)
                        writer.write(self._chunk(
                            cid, created, h,
                            {"role": "assistant", "content": ""}, None))
                        headers_sent = True
                    payload = dict(payload or {})
                    payload["timing"] = h.timing()
                    writer.write(self._chunk(cid, created, h, {}, "stop",
                                             extra=payload))
                    writer.write(b"data: [DONE]\n\n")
                    await writer.drain()
                    self.counters["streams"] += 1
                    self.counters["tokens_out"] += h.tokens
                    self._record(h, "ok")
                    return
                if kind == "failed":
                    await self._fail(writer, h, payload, headers_sent,
                                     cid, created)
                    return
                if kind == "client_gone":
                    self._cancel(h)
                    return
                if kind == "timeout":
                    self._cancel(h)
                    if not headers_sent:
                        await self._send_error(writer, GatewayError(
                            504, "timeout",
                            f"no completion within "
                            f"{self.request_timeout_s:.0f}s"))
                    return
        except (ConnectionResetError, BrokenPipeError):
            self._cancel(h)

    async def _unary_response(self, writer, h: _Pending, eof_task) -> None:
        cid = f"chatcmpl-{h.ticket}"
        created = int(time.time())
        deadline = h.loop.time() + self.request_timeout_s
        toks: List[int] = []
        try:
            while True:
                kind, payload = await self._next_event(h, eof_task, deadline)
                if kind == "token":
                    toks.append(payload)
                elif kind == "routed":
                    continue
                elif kind == "done":
                    info = dict(payload or {})
                    info["timing"] = h.timing()
                    n_prompt = (len(h.result.request.prompt_tokens)
                                if h.result is not None else 0)
                    await self._send_json(writer, 200, {
                        "id": cid, "object": "chat.completion",
                        "created": created, "model": h.model_name,
                        "choices": [{
                            "index": 0,
                            "message": {
                                "role": "assistant",
                                "content": "".join(_token_text(t)
                                                   for t in toks).rstrip()},
                            "finish_reason": "stop"}],
                        "usage": {"prompt_tokens": n_prompt,
                                  "completion_tokens": len(toks),
                                  "total_tokens": n_prompt + len(toks)},
                        "repro": info,
                    }, {"X-Repro-Served-By":
                        str(info.get("served_by"))})
                    self.counters["completions"] += 1
                    self.counters["tokens_out"] += h.tokens
                    self._record(h, "ok")
                    return
                elif kind == "failed":
                    await self._fail(writer, h, payload, False, cid, created)
                    return
                elif kind == "client_gone":
                    self._cancel(h)
                    return
                elif kind == "timeout":
                    self._cancel(h)
                    await self._send_error(writer, GatewayError(
                        504, "timeout",
                        f"no completion within "
                        f"{self.request_timeout_s:.0f}s"))
                    return
        except (ConnectionResetError, BrokenPipeError):
            self._cancel(h)

    async def _fail(self, writer, h: _Pending, payload: Dict,
                    headers_sent: bool, cid: str, created: int) -> None:
        """Map a typed execution failure onto the wire: 502 + attempt
        trace before any bytes went out, an SSE error frame after."""
        payload = dict(payload or {})
        status = int(payload.pop("status", 502))
        exc = GatewayError(status, payload.pop("code", "routing_failed"),
                           payload.pop("message", "request failed"),
                           detail={"attempts": payload.get("attempts", []),
                                   **{k: v for k, v in payload.items()
                                      if k != "attempts"}})
        self._record(h, f"failed_{status}")
        if not headers_sent:
            await self._send_error(writer, exc)
            return
        with contextlib.suppress(ConnectionResetError, BrokenPipeError):
            writer.write(f"data: {json.dumps(to_jsonable(exc.body()))}"
                         f"\n\n".encode())
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()


# ---------------------------------------------------------------------------
# demo boot: reduced-config pool + synthetic support set
# ---------------------------------------------------------------------------


def demo_gateway(pool=("qwen3-4b", "mamba2-370m"), router: str = "knn10",
                 *, n_support: int = 120, seed: int = 0, lam: float = 0.0,
                 engine_timeout_s: float = 10.0, max_slots: int = 4,
                 state_dir: Optional[str] = None, device: str = "cuda",
                 **gateway_kw) -> Gateway:
    """Build an (unstarted) gateway over a pool of reduced-config engines
    and a router fitted on the synthetic routed-serving support set, all on
    ``device`` (the card by default; ``"cpu"`` runs the kernels' plain
    versions).

    ``state_dir`` makes the service durable: observe() batches are
    write-ahead-logged and checkpointed there, and a directory that already
    holds a checkpoint boots through `RouterService.recover` (WAL-suffix
    replay) instead of refitting — restart = resume."""
    from pathlib import Path

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.routers import make_router
    from repro_torch.launch.serve import build_support
    from .encoder import default_encoder
    from .engine import ServingEngine

    engines = {name: ServingEngine(reduced(get_config(name)),
                                   max_slots=max_slots, cache_len=96,
                                   seed=i, device=device)
               for i, name in enumerate(pool)}
    encoder = default_encoder(device)
    svc_kw = dict(lam=lam, engine_timeout_s=engine_timeout_s,
                  encoder=encoder)
    ckpts = Path(state_dir) / "checkpoints" if state_dir else None
    if ckpts is not None and ckpts.exists() and any(ckpts.iterdir()):
        svc = RouterService.recover(state_dir, engines, device=device,
                                    **svc_kw)
    else:
        durability = None
        if state_dir:
            from .durability import DurabilityManager
            durability = DurabilityManager(state_dir, device=device)
        ds = build_support(list(pool), n=n_support, seed=seed,
                           encoder=encoder)
        svc = RouterService(make_router(router, device=device), engines,
                            ds=ds, seed=seed, durability=durability,
                            **svc_kw)
    return Gateway(svc, **gateway_kw)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8800)
    ap.add_argument("--pool", nargs="+",
                    default=["qwen3-4b", "mamba2-370m"])
    ap.add_argument("--router", default="knn10",
                    help="router spec string, e.g. knn100-ivfpq")
    ap.add_argument("--lam", type=float, default=0.0,
                    help="service default lambda (overridden per request "
                         "by '@lam=' in the model name)")
    ap.add_argument("--device", default="cuda",
                    help="where the engines, encoder and router run "
                         "(default: the card; cpu runs the plain versions)")
    ap.add_argument("--state-dir", default=None,
                    help="durability root (WAL + checkpoints); a dir that "
                         "already holds a checkpoint boots via recovery "
                         "replay instead of refitting")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="SIGTERM graceful-drain budget in seconds")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    gw = demo_gateway(tuple(args.pool), args.router, lam=args.lam,
                      state_dir=args.state_dir, device=args.device,
                      host=args.host, port=args.port)
    with gw:
        gw.install_signal_handlers(drain_timeout_s=args.drain_timeout)
        print(f"serving {gw.model_name} on http://{gw.host}:{gw.port} "
              f"({args.device}; POST /v1/chat/completions, GET /health "
              f"/stats; SIGTERM drains gracefully)", flush=True)
        try:
            while not gw._closed:
                time.sleep(0.2)
        except KeyboardInterrupt:
            print("shutting down")


if __name__ == "__main__":
    main()
