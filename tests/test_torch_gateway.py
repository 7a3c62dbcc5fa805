"""The port's OpenAI-compatible streaming gateway (`repro_torch.serving.
gateway`), driven live over a TCP socket with stdlib ``http.client`` and
raw sockets, on `demo_gateway(device="cpu")` (reduced qwen3-4b and
mamba2-370m engines, `knn10`): requests ride `MicroBatcher` ->
`route_fused` -> `RouterService.execute` -> SSE as in production.  Every
socket carries a timeout; shutdown runs under the deadlock watchdog.

Against the JAX package: `parse_model_name` gives the reference's 400
codes on the reference's table of bad names, and one request sent to the
reference's gateway and to the port's, each over pools with the same
weights (`params_from_jax`; the reference engine waits for each step),
streams the same tokens from the same engine."""
from __future__ import annotations

import http.client
import inspect
import json
import socket
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving.faults import FaultInjector  # noqa: E402
from repro_torch.serving.gateway import (MODEL_PREFIX,  # noqa: E402
                                         Gateway, GatewayError, demo_gateway,
                                         parse_model_name)
from repro_torch.serving.router_service import RouterService  # noqa: E402

SPEC = "knn10"
MODEL = MODEL_PREFIX + SPEC
POOL = ("qwen3-4b", "mamba2-370m")


@pytest.fixture(scope="module")
def gw():
    g = demo_gateway(device="cpu", max_batch=8, close_timeout_s=0.01,
                     max_new_tokens_cap=40).start()
    yield g
    g.close()


def _service(gw, engines=None, **kw):
    """A second service over the module gateway's fitted router and
    engines (``engines`` overrides some of them)."""
    kw.setdefault("engine_timeout_s", 10.0)
    pool = dict(gw.service.engines, **(engines or {}))
    return RouterService(gw.service.router, pool,
                         encoder=gw.service.encoder, **kw)


def _gateway(service, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("close_timeout_s", 0.01)
    return Gateway(service, **kw)


# ---------------------------------------------------------------------------
# stdlib HTTP helpers (every connection carries a timeout)
# ---------------------------------------------------------------------------

def _get(port, path, timeout=30):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def _post(port, path, body, timeout=60):
    if isinstance(body, dict):
        body = json.dumps(body)
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", path, body=body,
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def _chat(port, *, model=MODEL, content="algebra proofs question",
          max_tokens=3, stream=False, timeout=60):
    return _post(port, "/v1/chat/completions", {
        "model": model, "stream": stream, "max_tokens": max_tokens,
        "messages": [{"role": "user", "content": content}]}, timeout)


def _frames(raw: bytes):
    return [ln[6:].decode() for ln in raw.split(b"\n")
            if ln.startswith(b"data: ")]


def _raw_chat_socket(port, *, content="held request", max_tokens=2):
    """A streamed completion over a raw socket whose response is not
    read: the held / abandoned client."""
    body = json.dumps({"model": MODEL, "stream": True,
                       "max_tokens": max_tokens,
                       "messages": [{"role": "user", "content": content}]})
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    s.sendall((f"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
    return s


def _wait_until(cond, timeout=15.0, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out after {timeout}s waiting for {msg}")


# ---------------------------------------------------------------------------
# endpoints
# ---------------------------------------------------------------------------

def test_health_live_models_and_stats(gw):
    status, _, body = _get(gw.port, "/health")
    payload = json.loads(body)
    assert status == 200 and payload["status"] == "ok"
    assert payload["available"] == {m: True for m in POOL}
    assert _get(gw.port, "/health/live")[:1] == (200,)
    status, _, body = _get(gw.port, "/v1/models")
    assert status == 200
    assert json.loads(body)["data"][0]["id"] == MODEL
    assert json.loads(body)["data"][0]["root"] == SPEC
    assert _chat(gw.port, max_tokens=2)[0] == 200
    status, _, body = _get(gw.port, "/stats")
    st = json.loads(body)
    assert status == 200 and st["model"] == MODEL
    assert st["service"]["spec"] == SPEC
    assert st["service"]["durability"] is None
    assert st["gateway"]["batcher"]["flushes"] >= 1
    assert st["gateway"]["ttft_p50_s"] > 0
    assert json.loads(json.dumps(st)) == st


def test_stream_sse_well_formed(gw):
    n_tok = 4
    status, headers, raw = _chat(gw.port, max_tokens=n_tok, stream=True)
    frames = _frames(raw)
    assert status == 200
    assert headers["Content-Type"] == "text/event-stream"
    assert headers["X-Repro-Served-By"] in POOL
    assert frames[-1] == "[DONE]"
    chunks = [json.loads(f) for f in frames[:-1]]
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert len(chunks) == n_tok + 2
    assert len({c["id"] for c in chunks}) == 1
    for c in chunks:
        assert c["object"] == "chat.completion.chunk"
        assert c["choices"][0]["index"] == 0
    for c in chunks[1:-1]:
        assert c["choices"][0]["delta"]["content"].strip().isdigit()
        assert c["choices"][0]["finish_reason"] is None
    final = chunks[-1]
    assert final["choices"][0]["finish_reason"] == "stop"
    assert final["repro"]["served_by"] == headers["X-Repro-Served-By"]
    for stage in ("queue_wait_s", "wave_close_s", "route_s",
                  "first_token_s", "stream_s", "total_s"):
        assert final["repro"]["timing"][stage] >= 0.0


def test_unary_completion_shape(gw):
    status, headers, body = _chat(gw.port, max_tokens=3)
    payload = json.loads(body)
    assert status == 200 and payload["object"] == "chat.completion"
    assert headers["X-Repro-Served-By"] == payload["repro"]["served_by"]
    choice = payload["choices"][0]
    assert choice["finish_reason"] == "stop"
    assert len(choice["message"]["content"].split()) == 3
    usage = payload["usage"]
    assert usage["completion_tokens"] == 3
    assert usage["total_tokens"] == usage["prompt_tokens"] + 3


def test_per_request_lam_switches_engine(gw):
    """The cost threshold in the model NAME changes the routing decision:
    a text whose quality-first choice is not the cheapest engine moves to
    the cheapest at a large lambda, as the service routes it directly."""
    svc = gw.service
    texts = [f"{t} question" for t in ("python programming",
                                       "world history", "algebra proofs",
                                       "poetry writing", "biology facts")]
    emb = svc.encoder.embed_texts(texts)
    q = svc.route_embeddings(emb, 0.0)
    c = svc.route_embeddings(emb, 1e4)
    i = next(i for i in range(len(texts)) if q[i] != c[i])
    _, h_q, _ = _chat(gw.port, model=f"{MODEL}@lam=0", content=texts[i])
    _, h_c, _ = _chat(gw.port, model=f"{MODEL}@lam=10000", content=texts[i])
    assert h_q["X-Repro-Served-By"] == svc.model_names[q[i]]
    assert h_c["X-Repro-Served-By"] == svc.model_names[c[i]]


# ---------------------------------------------------------------------------
# error mapping: 400 / 404 / 405, structured, never a traceback
# ---------------------------------------------------------------------------

BAD_MODELS = [("gpt-4", "model_prefix"), ("", "model_missing"),
              ("repro/zzz9", "bad_spec"), ("repro/knn7", "wrong_router"),
              ("repro/knn5-ivf", "wrong_router"),
              ("repro/knn5@nprobe=4", "immutable_router"),
              ("repro/knn5@lam=abc", "bad_lam")]


@pytest.mark.parametrize("bad_model,code", BAD_MODELS)
def test_bad_model_names_give_the_reference_codes(bad_model, code):
    """The reference's table against a service serving ``knn5``: both
    packages' parsers raise the same 400 code; good names give the same
    lambda."""
    from repro.serving.gateway import GatewayError as JaxGatewayError
    from repro.serving.gateway import parse_model_name as jax_parse

    class Served:
        spec = "knn5"

    with pytest.raises(JaxGatewayError) as je:
        jax_parse(bad_model, Served)
    with pytest.raises(GatewayError) as te:
        parse_model_name(bad_model, Served)
    assert (te.value.status, te.value.code) == (je.value.status,
                                                je.value.code) == (400, code)
    tb, jb = te.value.body()["error"], je.value.body()["error"]
    assert tb.keys() == jb.keys() and tb["type"] == jb["type"]
    if code != "bad_spec":      # that message lists each build's families
        assert tb == jb
    for good in ("repro/knn5", "repro/knn5@lam=0.35", "repro/knn5@lam=2"):
        assert parse_model_name(good, Served) == jax_parse(good, Served)


@pytest.mark.parametrize("bad_model,code", [
    (m.replace("knn5", "knn10") if m.startswith("repro/knn5") else m, c)
    for m, c in BAD_MODELS])
def test_bad_model_names_are_structured_400(gw, bad_model, code):
    status, _, body = _chat(gw.port, model=bad_model)
    assert status == 400
    err = json.loads(body)["error"]
    assert err["code"] == code and err["type"] == "invalid_request_error"
    assert b"Traceback" not in body


@pytest.mark.parametrize("body,code", [
    ("{not json", "bad_json"),
    (json.dumps({"model": MODEL}), "messages_missing"),
    (json.dumps({"model": MODEL, "messages": []}), "messages_missing"),
    (json.dumps({"model": MODEL,
                 "messages": [{"role": "user", "content": 7}]}),
     "bad_message"),
    (json.dumps({"model": MODEL, "max_tokens": 0,
                 "messages": [{"role": "user", "content": "x"}]}),
     "bad_max_tokens"),
])
def test_bad_request_bodies_are_structured_400(gw, body, code):
    status, _, raw = _post(gw.port, "/v1/chat/completions", body)
    assert status == 400
    assert json.loads(raw)["error"]["code"] == code
    assert b"Traceback" not in raw


def test_unknown_route_404_and_wrong_method_405(gw):
    status, _, body = _get(gw.port, "/nope")
    assert status == 404 and json.loads(body)["error"]["code"] == "not_found"
    assert _post(gw.port, "/health", "{}")[0] == 405
    status, _, body = _get(gw.port, "/v1/chat/completions")
    assert status == 405
    assert json.loads(body)["error"]["code"] == "method_not_allowed"


# ---------------------------------------------------------------------------
# overload, cancellation, outages
# ---------------------------------------------------------------------------

def test_overload_sheds_429_with_retry_after(gw):
    g = _gateway(_service(gw), max_pending=1, close_timeout_s=30.0).start()
    try:
        held = _raw_chat_socket(g.port)
        _wait_until(lambda: g.batcher.pending() == 1, msg="held submit")
        status, headers, body = _chat(g.port, timeout=30)
        assert status == 429
        assert int(headers["Retry-After"]) >= 1
        err = json.loads(body)["error"]
        assert err["type"] == "overloaded_error" and err["code"] == "overloaded"
        assert err["retry_after_s"] > 0
        assert g.batcher.shed == 1
        held.close()
    finally:
        g.close()


def test_cancel_queued_releases_admission_slot(gw):
    g = _gateway(_service(gw), max_pending=1, close_timeout_s=0.3).start()
    try:
        held = _raw_chat_socket(g.port)
        _wait_until(lambda: g.batcher.pending() == 1, msg="held submit")
        held.close()                  # EOF -> the gateway cancels the ticket
        _wait_until(lambda: g.counters["cancelled"] >= 1
                    and g.batcher.pending() == 0, msg="queued cancel")
        assert _chat(g.port, max_tokens=2)[0] == 200
        assert g.batcher.shed == 0
    finally:
        g.close()


def test_midstream_disconnect_frees_engine_slot(gw):
    svc = _service(gw)
    g = _gateway(svc, max_new_tokens_cap=40).start()
    try:
        want = 40
        s = _raw_chat_socket(g.port, max_tokens=want)
        f = s.makefile("rb")
        assert b"200" in f.readline()
        while f.readline().strip():           # the response headers
            pass
        frames = 0
        while frames < 3:                     # role + 2 token chunks
            if f.readline().strip().startswith(b"data: "):
                frames += 1
        f.close()
        s.close()                             # hang up mid-stream
        _wait_until(lambda: g.counters["cancelled"] >= 1, msg="cancel")
        _wait_until(lambda: len(svc.log) >= 1, msg="wave drained")
        req = svc.log[-1].request
        assert req.error == "cancelled" and not req.done
        assert len(req.output_tokens) < want
        for eng in svc.engines.values():
            _wait_until(lambda: all(r is None for r in eng.slot_req),
                        msg="slots freed")
        assert _chat(g.port, max_tokens=2)[0] == 200
    finally:
        g.close()


def test_total_outage_maps_502_and_health_503(gw):
    chaos = {m: FaultInjector(e, mode="raise")
             for m, e in gw.service.engines.items()}
    svc = _service(gw, chaos, breaker={"failure_threshold": 1,
                                       "base_backoff_s": 60.0},
                   max_route_attempts=2)
    g = _gateway(svc).start()
    try:
        status, _, body = _chat(g.port, model=f"{MODEL}@lam=0")
        assert status == 502
        err = json.loads(body)["error"]
        assert err["type"] == "server_error"
        assert err["code"] == "routing_failed"
        assert set(err["attempts"]) == set(POOL)
        assert b"Traceback" not in body
        assert g.counters["failed_502"] == 1
        assert sum(c.injected["raise"] for c in chaos.values()) == 2
        status, _, body = _get(g.port, "/health")
        assert status == 503 and json.loads(body)["status"] == "degraded"
    finally:
        g.close()


def test_outage_reroutes_to_next_best_and_heals(gw):
    """One engine down: its requests are served by the next-best model
    with ``rerouted_from`` set, /health reads 503 while its breaker is
    open, the next wave routes around it, and after `heal()` and the
    backoff (on the breakers' injected clock, so a slow wave cannot let it
    elapse early) /health is 200 again."""
    svc0 = gw.service
    emb = svc0.encoder.embed_texts(["algebra proofs question"])
    victim = svc0.model_names[svc0.route_embeddings(emb, 0.0)[0]]
    other = next(m for m in POOL if m != victim)
    chaos = FaultInjector(gw.service.engines[victim], mode="raise")
    now = [0.0]
    svc = _service(gw, {victim: chaos}, breaker={
        "failure_threshold": 1, "base_backoff_s": 5.0,
        "clock": lambda: now[0]})
    g = _gateway(svc).start()
    try:
        status, headers, raw = _chat(g.port, model=f"{MODEL}@lam=0",
                                     max_tokens=4, stream=True)
        chunks = [json.loads(f) for f in _frames(raw)[:-1]]
        assert status == 200 and headers["X-Repro-Served-By"] == other
        assert chunks[-1]["repro"]["rerouted_from"] == [victim]
        assert len(chunks) == 4 + 2          # the stream moved with it
        status, _, body = _get(g.port, "/health")
        payload = json.loads(body)
        assert status == 503 and payload["status"] == "degraded"
        assert payload["engines"][victim]["state"] == "open"
        status, headers, body = _chat(g.port, model=f"{MODEL}@lam=0")
        assert headers["X-Repro-Served-By"] == other
        assert json.loads(body)["repro"]["rerouted_from"] == []
        assert chaos.injected["raise"] == 1
        chaos.heal()
        now[0] += 5.0                         # the backoff elapses
        assert _get(g.port, "/health")[0] == 200
        status, headers, _ = _chat(g.port, model=f"{MODEL}@lam=0")
        assert headers["X-Repro-Served-By"] == victim
        assert svc.health[victim].state == "closed"
    finally:
        g.close()


def test_hang_times_out_and_heal_releases_it(gw):
    """A hung engine: the wave's deadline reroutes its requests, and
    `heal()` releases the hung worker so nothing is left running."""
    emb = gw.service.encoder.embed_texts(["world history question"])
    victim = gw.service.model_names[gw.service.route_embeddings(emb, 0.0)[0]]
    chaos = FaultInjector(gw.service.engines[victim], mode="hang")
    # the deadline holds every engine's wave, the rerouted one's too: long
    # enough for a wave of the reduced engines on a loaded CPU
    svc = _service(gw, {victim: chaos}, engine_timeout_s=5.0,
                   breaker={"failure_threshold": 1, "base_backoff_s": 60.0})
    g = _gateway(svc).start()
    try:
        status, _, body = _chat(g.port, model=f"{MODEL}@lam=0",
                                content="world history question")
        assert status == 200
        assert json.loads(body)["repro"]["rerouted_from"] == [victim]
        assert svc.health[victim].timeouts == 1
    finally:
        chaos.heal()
        g.close()
    _wait_until(lambda: not any(t.name == f"engine-wave-{victim}"
                                for t in threading.enumerate()),
                msg="hung worker released")


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def test_drain_rejects_new_work_then_takes_port_dark(gw):
    g = _gateway(_service(gw)).start()
    port = g.port
    assert _chat(port, max_tokens=2)[0] == 200
    g.begin_drain()
    status, _, body = _chat(port, max_tokens=2)
    assert status == 503 and json.loads(body)["error"]["code"] == "draining"
    status, _, body = _get(port, "/health")
    assert status == 503 and json.loads(body)["status"] == "draining"
    assert _get(port, "/health/live")[0] == 200
    g.drain(timeout_s=10.0)
    assert not g._pump_thread.is_alive() and not g._http_thread.is_alive()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2)


def test_clean_shutdown_under_watchdog(gw, watchdog):
    g = _gateway(_service(gw)).start()
    port = g.port

    def fire():
        try:
            _chat(port, max_tokens=2, timeout=30)
        except (ConnectionError, http.client.HTTPException, OSError):
            pass                  # shutdown racing the request is the point

    for _ in range(2):
        threading.Thread(target=fire, daemon=True).start()
    time.sleep(0.05)
    watchdog([g.close], timeout=30.0)
    assert not g._pump_thread.is_alive()
    assert not g._http_thread.is_alive()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2)


def test_state_dir_raises_typed_error_and_device_defaults_to_card(tmp_path):
    """A durable gateway (``state_dir``) boots with its bootstrap
    checkpoint, takes feedback through ``observe``, and its drain writes a
    final checkpoint; booting again on the same directory recovers (WAL
    replay, readiness "ok" once ready) to the same support and choices.
    The entry point's device defaults to the card."""
    state = str(tmp_path / "state")
    g = demo_gateway(device="cpu", state_dir=state, max_batch=8,
                     close_timeout_s=0.01).start()
    svc = g.service
    dur = svc.durability
    assert dur is not None and dur.checkpoints_written == 1
    assert svc.recovery_status() is None
    texts = ["poetry writing question", "world history question"]
    support = svc.observe(texts, np.array([[0.1, 5.0], [0.1, 5.0]],
                                          np.float32))
    assert dur.applied_seq == 0 and _get(g.port, "/health")[0] == 200
    stats = json.loads(_get(g.port, "/stats")[2])
    assert stats["service"]["durability"]["wal"]["applied_seq"] == 0
    before = dur.checkpoints_written
    g.begin_drain()
    assert _get(g.port, "/health")[0] == 503
    g.drain(timeout_s=10.0)
    assert dur.checkpoints_written == before + 1
    choice = svc.route_embeddings(svc.encoder.embed_texts(texts))
    g2 = demo_gateway(device="cpu", state_dir=state).start()
    try:
        rec = g2.service.recovery_status()
        assert rec["status"] == "ready" and rec["checkpoint_covered_seq"] == 0
        assert g2.service.router.support_size == support
        np.testing.assert_array_equal(g2.service.route_embeddings(
            g2.service.encoder.embed_texts(texts)), choice)
        assert _get(g2.port, "/health")[0] == 200
    finally:
        g2.close()
    assert inspect.signature(demo_gateway).parameters["device"].default \
        == "cuda"


def test_pump_builds_no_autograd_graph(gw):
    """Grad mode is per thread: a route from a fresh thread (grad on) with
    support tensors that require grad returns numpy, and a served request
    leaves no ``grad_fn`` on any engine cache."""
    svc = gw.service
    S, C = svc.router._support_dev()
    saved = {n: svc.router._dev[n] for n in ("S", "C")}
    for n, t in (("S", S), ("C", C)):
        svc.router._dev[n] = (t.clone().requires_grad_(True), t.shape[0])
    box = {}

    def route():
        try:
            box["out"] = svc.submit_texts(["poetry writing question"])
        except Exception as exc:
            box["exc"] = exc

    try:
        t = threading.Thread(target=route)
        t.start()
        t.join(30)
        assert "exc" not in box, box.get("exc")
        assert box["out"][0].model in POOL
        assert _chat(gw.port, max_tokens=2)[0] == 200
    finally:
        svc.router._dev.update(saved)
    for eng in svc.engines.values():
        for cache in eng.caches:
            assert all(v.grad_fn is None for v in cache.values())


# ---------------------------------------------------------------------------
# the same request through the reference's gateway and the port's
# ---------------------------------------------------------------------------

def test_same_request_streams_the_same_tokens_in_both_packages():
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.configs.base import ATTN_DENSE, ModelConfig
    from repro.core.routers import make_router as jax_make
    from repro.launch.serve import build_support as jax_build_support
    from repro.models import model as jax_M
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro.serving.gateway import Gateway as JaxGateway
    from repro.serving.router_service import RouterService as JaxService
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.dataset import RoutingDataset
    from repro_torch.core.routers import make_router
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serving.encoder import ENCODER_CFG, QueryEncoder
    from repro_torch.serving.engine import ServingEngine

    pool = ["qwen3-4b", "h2o-danube-1.8b"]
    j_eng, t_eng = {}, {}
    for i, name in enumerate(pool):
        je = JaxEngine(jax_reduced(jax_get_config(name)), max_slots=2,
                       cache_len=48, seed=i)
        dec = je._decode
        je._decode = lambda *a, _d=dec: jax.block_until_ready(_d(*a))
        j_eng[name] = je
        t_eng[name] = ServingEngine(
            reduced(get_config(name)),
            params_from_jax(jax.tree.map(np.asarray, je.params),
                            reduced(get_config(name))),
            max_slots=2, cache_len=48, device="cpu")
    enc_cfg = ModelConfig(
        name="query-encoder", arch_type="dense", n_layers=2, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=1536, vocab_size=8192,
        pattern=(ATTN_DENSE,), n_groups=2, dtype="float32", remat=False)
    enc_params = jax.tree.map(np.asarray, jax_M.init_params(
        jax.random.PRNGKey(7), enc_cfg))
    jds = jax_build_support(pool, n=120)
    tds = RoutingDataset(jds.name, jds.embeddings, jds.scores, jds.costs,
                         list(jds.model_names))
    jsvc = JaxService(jax_make("knn10"), j_eng, ds=jds, engine_timeout_s=30)
    tsvc = RouterService(make_router("knn10", device="cpu"), t_eng, ds=tds,
                         engine_timeout_s=30, encoder=QueryEncoder(
                             params_from_jax(enc_params, ENCODER_CFG),
                             device="cpu"))
    # a text whose quality-first choice differs from the cheapest engine
    texts = [f"{t} request number {i}" for i, t in enumerate(
        ["python programming", "world history", "algebra proofs",
         "poetry writing", "biology facts"])]
    emb = tsvc.encoder.embed_texts(texts)
    q, c = tsvc.route_embeddings(emb, 0.0), tsvc.route_embeddings(emb, 1e4)
    text = texts[next(i for i in range(len(texts)) if q[i] != c[i])]
    got = {}
    for name, cls, svc in (("jax", JaxGateway, jsvc),
                           ("port", Gateway, tsvc)):
        g = cls(svc, max_batch=8, close_timeout_s=0.01).start()
        try:
            got[name] = []
            for lam in (0, 10000):
                status, headers, raw = _chat(
                    g.port, model=f"{MODEL}@lam={lam}", max_tokens=5,
                    stream=True, content=text)
                assert status == 200
                chunks = [json.loads(f) for f in _frames(raw)[:-1]]
                got[name].append((
                    headers["X-Repro-Served-By"],
                    [c["choices"][0]["delta"]["content"]
                     for c in chunks[1:-1]],
                    chunks[-1]["repro"]["served_by"]))
        finally:
            g.close()
    assert got["port"] == got["jax"]
    assert {served for served, _, _ in got["port"]} == set(pool)
    assert all(len(toks) == 5 for _, toks, _ in got["port"])
