"""The port's serving slice (`repro_torch.serving`, `repro_torch.launch`)
against the JAX package, from text to tokens: reduced engines with
converted params, the same support set, texts and per-request lambdas
through both packages' `RouterService.serve_texts` must choose the same
models and decode the same greedy tokens.  Plus the engine's slot
behaviour, the service's failover, and the port's import boundary."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.dataset import RoutingDataset  # noqa: E402
from repro_torch.core.routers import make_router  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import (IncompleteDrainError,  # noqa: E402
                                        Request, ServingEngine)
from repro_torch.serving.router_service import RouterService  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
POOL = ["qwen3-4b", "h2o-danube-1.8b"]


def test_port_imports_without_jax():
    code = ("import sys, repro_torch\n"
            "import repro_torch.kernels._build, repro_torch.launch.serve\n"
            "import repro_torch.models.convert, repro_torch.core.routers\n"
            "import repro_torch.kernels.knn_topk.ops\n"
            "import repro_torch.kernels.flash_attention.ops\n"
            "import repro_torch.kernels.decode_attention.ops\n"
            "import repro_torch.kernels.knn_ivf.ops, repro_torch.persist\n"
            "import repro_torch.core.routers.artifacts\n"
            "import repro_torch.serving.pipeline\n"
            "import repro_torch.kernels.ssd_scan.ops, repro_torch.models.ssm\n"
            "import repro_torch.launch.train, repro_torch.training.checkpoint\n"
            "import repro_torch.data.lm_data\n"
            "import repro_torch.serving.scheduler\n"
            "import repro_torch.serving.gateway\n"
            "import repro_torch.core.routers.dispatch\n"
            "import repro_torch.serving.durability\n"
            "import repro_torch.launch.kill_child\n"
            "import repro_torch.core.eval, repro_torch.core.diagnostics\n"
            "import repro_torch.core.routers.nn_utils\n"
            "import repro_torch.core.routers.linear, repro_torch.core.routers.mf\n"
            "import repro_torch.core.routers.mlp, repro_torch.core.routers.graph\n"
            "import repro_torch.core.routers.attentive\n"
            "import repro_torch.core.routers.bandit\n"
            "import repro_torch.data.synthetic, repro_torch.data.prices\n"
            "import repro_torch.data.routing_bench\n"
            "import repro_torch.models.moe, repro_torch.configs\n"
            "import repro_torch.configs.deepseek_v2_236b\n"
            "import repro_torch.configs.llama4_maverick_400b_a17b\n"
            "import repro_torch.configs.qwen1_5_32b\n"
            "import repro_torch.configs.starcoder2_15b\n"
            "import repro_torch.configs.zamba2_7b\n"
            "import repro_torch.configs.internvl2_76b\n"
            "import repro_torch.configs.seamless_m4t_medium\n"
            "from repro_torch.kernels.flash_attention.ops import "
            "flash_attention_bwd\n"
            "from repro_torch.kernels.flash_attention.ref import "
            "flash_attention_bwd_plain\n"
            "from repro_torch.training.checkpoint import save_lm, load_lm\n"
            "from repro_torch.models.convert import params_to_jax\n"
            "from repro_torch.configs import ARCHS\n"
            "assert len(ARCHS) == 10\n"
            "from repro_torch.core.routers import REGISTRY, PAPER_ORDER\n"
            "assert len(PAPER_ORDER) == 12 and 'linucb' in REGISTRY\n"
            "from repro_torch.kernels.knn_ivf.ops import DynamicIVFIndex\n"
            "import repro_torch.analysis, repro_torch.analysis.lint\n"
            "import repro_torch.analysis.core, repro_torch.analysis.callgraph\n"
            "import repro_torch.analysis.sanitizers\n"
            "import repro_torch.analysis.rules.host_sync\n"
            "import repro_torch.analysis.rules.lock_discipline\n"
            "import repro_torch.analysis.rules.schema_pin\n"
            "import repro_torch.analysis.rules.graph_capture\n"
            "import repro_torch.analysis.rules.swallow\n"
            "import repro_torch.analysis.rules.durable_write\n"
            "import repro_torch.kernels.knn_ivf.autotune\n"
            "import repro_torch.launch.mesh, repro_torch.launch.ab\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _jax_encoder_params():
    from repro.configs.base import ATTN_DENSE, ModelConfig
    from repro.models import model as jax_M
    cfg = ModelConfig(
        name="query-encoder", arch_type="dense", n_layers=2, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=1536, vocab_size=8192,
        pattern=(ATTN_DENSE,), n_groups=2, dtype="float32", remat=False)
    return jax.tree.map(np.asarray,
                        jax_M.init_params(jax.random.PRNGKey(7), cfg))


def _synchronous(fn):
    return lambda *args: jax.block_until_ready(fn(*args))


@pytest.mark.parametrize("spec", ["knn10", "knn100-ivfpq"])
def test_serve_texts_matches_reference_text_to_tokens(spec):
    from repro.core.routers import make_router as jax_make_router
    from repro.launch.serve import build_support as jax_build_support
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro.serving.router_service import RouterService as JaxService
    from repro_torch.serving.encoder import ENCODER_CFG, QueryEncoder

    j_engines, t_engines = {}, {}
    for i, name in enumerate(POOL):
        cache = 64 if name == "qwen3-4b" else 96
        je = JaxEngine(jax_reduced(jax_get_config(name)), max_slots=2,
                       cache_len=cache, seed=i)
        # the reference engine refills its host token buffer while the
        # previous asynchronous decode may still read it (jnp.asarray can
        # alias host memory on the CPU backend), which makes its greedy
        # stream vary from run to run; wait for each step to finish
        je._decode = _synchronous(je._decode)
        j_engines[name] = je
        t_engines[name] = ServingEngine(
            reduced(get_config(name)),
            params_from_jax(jax.tree.map(np.asarray, je.params),
                            reduced(get_config(name)), device="cpu"),
            max_slots=2, cache_len=cache, device="cpu")
    jds = jax_build_support(POOL, n=200)
    tds = RoutingDataset(jds.name, jds.embeddings, jds.scores, jds.costs,
                         list(jds.model_names))
    texts = [f"{t} request number {i}" for i, t in enumerate(
        ["python programming", "world history", "algebra proofs",
         "poetry writing", "biology facts", "python programming"])]
    lam = np.array([0.0, 1.0, 0.0, 50.0, 0.5, 200.0], np.float32)
    jsvc = JaxService(jax_make_router(spec), j_engines, ds=jds)
    tsvc = RouterService(
        make_router(spec, device="cpu"), t_engines, ds=tds,
        encoder=QueryEncoder(params_from_jax(_jax_encoder_params(),
                                             ENCODER_CFG, device="cpu"),
                     device="cpu"))
    assert tsvc.retrieval_backend == jsvc.retrieval_backend
    jres = jsvc.serve_texts(texts, lam=lam, max_new_tokens=5)
    tres = tsvc.serve_texts(texts, lam=lam, max_new_tokens=5)
    assert [r.model for r in tres] == [r.model for r in jres]
    assert len({r.model for r in tres}) == 2        # both engines served
    for t, j in zip(tres, jres):
        assert t.request.done and not t.request.error
        np.testing.assert_array_equal(t.request.prompt_tokens,
                                      j.request.prompt_tokens)
        assert t.request.output_tokens == j.request.output_tokens
        np.testing.assert_allclose(t.s_row, j.s_row, atol=1e-5)
        np.testing.assert_allclose(t.confidence, j.confidence, atol=1e-5)
    # the staged chain agrees with the device path on the same embeddings
    emb = tsvc.encoder.embed_texts(texts)
    a, b = tsvc.route_fused(emb, lam), tsvc.route_legacy(emb, lam)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], atol=1e-6)


def _engine(name="qwen3-4b", **kw):
    cfg = reduced(get_config(name))
    return ServingEngine(cfg, max_slots=kw.pop("max_slots", 2),
                         cache_len=kw.pop("cache_len", 32), device="cpu",
                         **kw)


def test_engine_continuous_batching_and_cancel():
    eng = _engine()
    reqs = [Request(uid=i, prompt_tokens=np.arange(3 + i) + 1,
                    max_new_tokens=4) for i in range(3)]
    reqs[2].cancelled = True
    seen = []
    reqs[0].on_token = seen.append
    steps = eng.run_until_drained(reqs)
    assert reqs[0].done and reqs[1].done and not reqs[2].done
    assert reqs[2].error == "cancelled"
    assert reqs[0].output_tokens == seen and len(seen) == 4
    # 4 decode waves, then one wave that drops the cancelled request
    assert steps == 5 and eng.stats["tokens_out"] == 8
    assert eng.slot_req == [None, None]


def test_engine_incomplete_drain_marks_survivors():
    eng = _engine()
    reqs = [Request(uid=i, prompt_tokens=np.array([5, 6]),
                    max_new_tokens=10) for i in range(3)]
    with pytest.raises(IncompleteDrainError) as ei:
        eng.run_until_drained(reqs, max_steps=2)
    assert {r.uid for r in ei.value.survivors} == {0, 1, 2}
    assert all(r.error == "incomplete_drain" for r in reqs)
    assert eng.slot_req == [None, None]


class _BrokenEngine:
    def __init__(self, inner):
        self.inner = inner
        self.cfg = inner.cfg

    def run_until_drained(self, reqs, max_steps=10_000):
        raise RuntimeError("engine down")

    def release(self, reqs):
        return self.inner.release(reqs)


def test_execute_reroutes_failed_wave_to_next_best_model():
    from repro_torch.launch.serve import build_support
    from repro_torch.serving.encoder import QueryEncoder
    enc = QueryEncoder(device="cpu")
    ds = build_support(POOL, n=100, encoder=enc)
    engines = {"qwen3-4b": _engine("qwen3-4b"),
               "h2o-danube-1.8b": _engine("h2o-danube-1.8b")}
    svc = RouterService(make_router("knn10", device="cpu"), engines, ds=ds,
                        encoder=enc,
                        breaker={"failure_threshold": 1,
                                 "base_backoff_s": 3600.0})
    texts = ["python programming request", "world history request"]
    results = svc.submit_texts(texts, max_new_tokens=2, lam=0.0)
    victim = results[0].model
    other = next(m for m in POOL if m != victim)
    svc.engines[victim] = _BrokenEngine(engines[victim])
    report = svc.execute(results)
    assert report.errors and victim in report.errors
    assert all(r.model == other and r.request.done for r in results)
    assert report.rerouted and all(
        (f, t) == (victim, other) for _, f, t in report.rerouted)
    assert svc.health[victim].state == "open"
    assert svc.availability_mask().tolist() == [m != victim for m in POOL]


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    results = serve.main(["--device", "cpu", "--requests", "3",
                          "--max-new", "2"])
    assert len(results) == 3 and all(r.request.done for r in results)
    assert "[routing mix]" in capsys.readouterr().out


def test_serve_cli_saves_and_boots_from_artifact(tmp_path, capsys):
    from repro.core.routers import load_router as jax_load
    from repro_torch.launch import serve
    art = tmp_path / "router"
    results = serve.main(["--device", "cpu", "--router", "knn100-ivfpq",
                          "--save-artifact", str(art), "--requests", "3",
                          "--max-new", "2"])
    assert len(results) == 3 and all(r.request.done for r in results)
    out = capsys.readouterr().out
    assert "[artifact] saved knn100-ivfpq" in out and "[routing mix]" in out
    assert jax_load(art).index == "ivfpq"       # the reference reads it


def _prompt(i):
    return (np.arange(12) * (i + 3) + 7 * i) % 500 + 1


def _serve_alone(make_engine, prompt, n_new):
    from repro.serving.engine import Request as JaxRequest
    eng = make_engine()
    req_cls = JaxRequest if not isinstance(eng, ServingEngine) else Request
    req = req_cls(uid=0, prompt_tokens=prompt, max_new_tokens=n_new)
    eng.run_until_drained([req])
    assert req.done
    return req.output_tokens


def test_mamba_engine_matches_reference_one_request_per_engine():
    """reduced(mamba2-370m) with the reference's weights: greedy tokens of
    each request served alone in a fresh engine, in both packages (where
    the reference's SSM state does not leak between slots)."""
    from repro.serving.engine import ServingEngine as JaxEngine
    jcfg = jax_reduced(jax_get_config("mamba2-370m"))
    cfg = reduced(get_config("mamba2-370m"))
    je = JaxEngine(jcfg, max_slots=2, cache_len=32, seed=3)
    tree = jax.tree.map(np.asarray, je.params)

    def jax_engine():
        e = JaxEngine(jcfg, params=je.params, max_slots=2, cache_len=32)
        e._decode = _synchronous(e._decode)
        return e

    def port_engine():
        return ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                             max_slots=2,
                             cache_len=32, device="cpu")
    for i in range(2):
        want = _serve_alone(jax_engine, _prompt(i), 8)
        got = _serve_alone(port_engine, _prompt(i), 8)
        assert got == want and len(got) == 8


def test_mamba_engine_isolates_requests():
    """Request A's tokens are the same served alone and with B admitted
    into the other slot while A is mid-stream (the reference's engine
    feeds every slot and leaks B's tokens into A's state)."""
    from repro_torch.models import model as M
    cfg = reduced(get_config("mamba2-370m"))
    lm = M.init_params(cfg, seed=3, device="cpu")

    def engine():
        return ServingEngine(cfg, params=lm, max_slots=2, cache_len=32,
                             device="cpu")
    alone = _serve_alone(engine, _prompt(0), 8)
    eng = engine()
    a = Request(uid=0, prompt_tokens=_prompt(0), max_new_tokens=8)
    b = Request(uid=1, prompt_tokens=_prompt(1), max_new_tokens=8)
    eng.admit(a)
    for _ in range(3):
        eng.step()
    eng.admit(b)                      # prefilled while A is mid-stream
    eng.run_until_drained([])
    assert a.done and b.done
    assert a.output_tokens == alone
    assert b.output_tokens == _serve_alone(engine, _prompt(1), 8)


def test_serve_cli_default_pool_is_the_references():
    import argparse
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    class Parsed(Exception):
        pass

    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise Parsed(real(self, [], namespace))
    pools = []
    for mod in (serve, jax_serve):
        argparse.ArgumentParser.parse_args = capture
        try:
            mod.main()
        except Parsed as p:
            pools.append(p.args[0].pool)
        finally:
            argparse.ArgumentParser.parse_args = real
    assert pools[0] == pools[1] == ["qwen3-4b", "mamba2-370m",
                                    "h2o-danube-1.8b"]
