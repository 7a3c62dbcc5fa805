#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one GPU
    python3 chip_smoke.py --kernels  # phases 1-3 only (build + kernel checks)

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. device: the card's name and count, its power limit from nvidia-smi;
     TF32 is switched off for matmuls and convolutions, so f32 is f32.
  2. build: every CUDA kernel of the port compiled from this checkout's
     sources with nvcc (one process per source, all started together).
  3. kernels: each kernel against its plain-torch version on the card at
     the serving path's shapes, with the max error against a stated
     tolerance, the kernel's, the plain version's and (where one PyTorch
     call computes the same function) the library call's time in ms, and
     the least time the card could take (bytes over 3.35 TB/s or flops over
     the dtype's peak, whichever is larger).
  4. main path at full width: engines for qwen3-4b and h2o-danube-1.8b at
     their published widths in bf16 (seeded random weights), a 100,000-row
     support set embedded by the port's query encoder, `knn10` fitted on
     it, and 16 texts served at per-request lambdas through
     `RouterService.serve_texts`.  The kernels' launch counters are zeroed
     just before and read just after; each kernel must have run.  The
     routing of all 16 texts is checked against the plain tail on the CPU
     fed with the kernel's neighbours, the neighbours against the plain
     retrieval, and a reduced engine's greedy tokens against the same
     engine on the CPU.
The line before the last is the kernels' JSON summary, the last line the
device record.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
KERNEL_SOURCES = {
    "knn_topk": ("src/repro_torch/kernels/knn_topk/kernel.cu",
                 "src/repro/kernels/knn_topk/kernel.py:79"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/kernel.cu",
                        "src/repro/kernels/flash_attention/kernel.py:90"),
    "decode_attention": ("src/repro_torch/kernels/decode_attention/kernel.cu",
                         "src/repro/kernels/decode_attention/kernel.py:63"),
}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


class Timer:
    """Mean device ms of ``fn`` over ``iters`` runs, each bracketed by CUDA
    events, with a 256 MB write in between so every run starts with a cold
    L2.  A ~5 ms device spin before each run lets the host queue all of
    ``fn``'s launches first, so the wrapper's Python overhead is not timed
    as device time."""

    SPIN_CYCLES = 10_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, iters=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def knn_case(torch, timer, Q, N, D, k, dtype, tol, gen):
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_reference
    q = torch.randn(Q, D, device="cuda", generator=gen)
    q = q / q.norm(dim=1, keepdim=True)
    s = torch.randn(N, D, device="cuda", generator=gen).to(dtype)
    out_s, out_i = knn_topk(q, s, k)
    ref_s, ref_i = knn_topk_reference(q, s, k)
    torch.cuda.synchronize()
    fin = torch.isfinite(ref_s)
    assert torch.equal(fin, torch.isfinite(out_s)), "empty slots differ"
    assert torch.equal(out_i < 0, ~fin), "ids of empty slots must be -1"
    err = float((out_s[fin] - ref_s[fin]).abs().max()) if fin.any() else 0.0
    # every returned id must point at a row with the returned score
    sims = (q.to(dtype).float() @ s.float().T) * torch.rsqrt(
        (s.float() ** 2).sum(1) + 1e-12)
    got = sims.gather(1, out_i.clamp_min(0).long())
    id_err = float((got - out_s)[fin].abs().max()) if fin.any() else 0.0
    assert err <= tol and id_err <= tol, (err, id_err, tol)
    del sims, got
    ms = timer(lambda: knn_topk(q, s, k))
    plain = timer(lambda: knn_topk_reference(q, s, k))
    esz = s.element_size()
    b_ms, b_by = bound(Q * D * 4 + N * D * esz + Q * k * 8,
                       2 * Q * N * D + 2 * N * D, dtype)
    return dict(case=f"Q={Q} N={N} D={D} k={k} {str(dtype)[6:]}",
                max_abs_err=max(err, id_err), tol=tol, ms=ms, plain_ms=plain,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def live_pairs(Sq, Sk, causal, window):
    n = 0
    for i in range(Sq):
        lo = max(0, i - window + 1) if window else 0
        hi = min(Sk, i + 1) if causal else Sk
        n += max(0, hi - lo)
    return n


def flash_case(torch, timer, B, S, H, KV, hd, dtype, causal, window, tol,
               gen):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_reference)
    q = torch.randn(B, S, H, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, S, KV, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, S, KV, hd, device="cuda", generator=gen).to(dtype)
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention_reference(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    ref_std = float(ref.float().std())
    assert err <= tol, (err, tol)
    ms = timer(lambda: flash_attention(q, k, v, causal=causal, window=window))
    plain = timer(lambda: flash_attention_reference(q, k, v, causal=causal,
                                                    window=window), iters=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        i = torch.arange(S, device="cuda")
        m = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        lib = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m, enable_gqa=KV != H))
    else:
        lib = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=KV != H))
    esz = q.element_size()
    b_ms, b_by = bound(2 * (B * S * H * hd + B * S * KV * hd) * esz,
                       4 * B * H * hd * live_pairs(S, S, causal, window),
                       dtype)
    return dict(case=f"B={B} S={S} H={H} KV={KV} hd={hd} {str(dtype)[6:]} "
                     f"causal={causal} window={window}",
                max_abs_err=err, tol=tol, ref_std=ref_std, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def decode_case(torch, timer, pos, S, KV, G, hd, dtype, ring, tol, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_reference)
    B, H = len(pos), KV * G
    q = torch.randn(B, H, hd, device="cuda", generator=gen).to(dtype)
    ck = torch.randn(B, S, KV, hd, device="cuda", generator=gen).to(dtype)
    cv = torch.randn(B, S, KV, hd, device="cuda", generator=gen).to(dtype)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    out = decode_attention(q, ck, cv, p, ring=ring)
    ref = decode_attention_reference(q, ck, cv, p, ring=ring)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    ref_std = float(ref.float().std())
    assert err <= tol, (err, tol)
    ms = timer(lambda: decode_attention(q, ck, cv, p, ring=ring))
    plain = timer(lambda: decode_attention_reference(q, ck, cv, p, ring=ring))
    s_idx = torch.arange(S, device="cuda")[None, :]
    pb = p.long()[:, None]
    valid = (pb - torch.remainder(pb - s_idx, S) >= 0) if ring \
        else (s_idx <= pb)
    qs, ks, vs = q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2)
    mask = valid[:, None, None, :]
    lib = timer(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=G > 1))
    n_valid = int(valid.sum())
    esz = q.element_size()
    b_ms, b_by = bound(2 * B * H * hd * esz + 2 * n_valid * KV * hd * esz
                       + 4 * B, 4 * H * hd * n_valid, dtype)
    return dict(case=f"pos={pos} S={S} KV={KV} G={G} hd={hd} "
                     f"{str(dtype)[6:]} ring={ring}",
                max_abs_err=err, tol=tol, ref_std=ref_std, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def phase_kernels(torch):
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    main = {}
    # knn: the main path's shape first (16 texts against the 70,000-row
    # train split of 100,000 support rows), then the wider cases
    for i, (Q, N, k, dt, tol) in enumerate([
            (16, 70_000, 10, f32, 1e-5), (64, 100_000, 10, f32, 1e-5),
            (64, 100_000, 100, f32, 1e-5), (33, 100_003, 100, f32, 1e-5),
            (7, 50, 64, f32, 1e-5), (64, 100_000, 10, bf16, 1e-4)]):
        r = knn_case(torch, timer, Q, N, 768, k, dt, tol, gen)
        emit("kernel", name="knn_topk", **r)
        if i == 0:
            main["knn_topk"] = r
    # flash: the query encoder's shape (a chunk of 1024 texts), then bf16
    # GQA with hd=128 and a window, and danube's hd=80.  The plain versions
    # compute in f32; the bf16 limits (1e-2) sit near the bf16 rounding of
    # outputs of magnitude ~1, well below the outputs' own spread
    # (ref_std), so a dropped KV tile fails the check.
    for i, args in enumerate([
            (1024, 64, 12, 12, 64, f32, True, 0, 2e-5),
            (4, 1024, 32, 8, 128, bf16, True, 256, 1e-2),
            (2, 256, 32, 8, 80, f32, True, 64, 2e-5)]):
        r = flash_case(torch, timer, *args, gen=gen)
        emit("kernel", name="flash_attention", **r)
        if i == 0:
            main["flash_attention"] = r
    # decode: qwen3-4b's decode shape, then danube's hd=80 ring past S
    for i, args in enumerate([
            ([100, 511, 7, 300], 512, 8, 4, 128, bf16, False, 1e-2),
            ([700, 511, 1030, 5], 512, 8, 4, 80, bf16, True, 1e-2),
            ([700, 63, 64, 0], 64, 2, 2, 64, f32, True, 2e-5)]):
        r = decode_case(torch, timer, *args, gen=gen)
        emit("kernel", name="decode_attention", **r)
        if i == 0:
            main["decode_attention"] = r
    return main


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def phase_main_path(torch):
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.routers import make_router
    from repro_torch.core.routers.knn import _serve_tail
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.launch.serve import TOPICS, build_support
    from repro_torch.models import model as M
    from repro_torch.serving.encoder import QueryEncoder
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.router_service import RouterService

    wrappers = {"knn_topk": knn_topk, "flash_attention": flash_attention,
                "decode_attention": decode_attention}
    pool = ["qwen3-4b", "h2o-danube-1.8b"]
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    engines = stage("engines_init_s", lambda: {
        name: ServingEngine(get_config(name), max_slots=4, cache_len=512,
                            seed=i, device="cuda")
        for i, name in enumerate(pool)})
    encoder = QueryEncoder(device="cuda")
    ds = stage("support_embed_100k_s",
               lambda: build_support(pool, n=100_000, encoder=encoder))
    svc = stage("router_fit_s", lambda: RouterService(
        make_router("knn10", device="cuda"), engines, ds=ds,
        encoder=encoder))
    texts = [f"{TOPICS[i % len(TOPICS)]} request number {i}"
             for i in range(16)]
    lams = np.array([0.0, 0.5, 2.0, 100.0] * 4, np.float32)
    results = stage("serve_texts_s", lambda: svc.serve_texts(
        texts, lam=lams, max_new_tokens=8))
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    mix = {}
    for r in results:
        mix[r.model] = mix.get(r.model, 0) + 1
    emit("main_path", routing_mix=mix, stage_wall_s=stages,
         launches=launches, max_memory_allocated=peak,
         decode_steps={m: e.stats["decode_steps"] for m, e in engines.items()},
         tokens=[r.request.output_tokens for r in results])
    assert all(r.request.done and r.request.error is None for r in results)
    # execute() catches an engine's exception and reroutes: a kernel that
    # raised would show here, by name, not only in the routing mix
    rerouted = [r.uid for r in results if r.rerouted_from]
    assert not rerouted, f"requests rerouted after an engine failure: " \
        f"{rerouted}"
    assert all(len(r.request.output_tokens) == 8 for r in results)
    assert set(mix) == set(pool), f"both engines must serve: {mix}"
    for r in results:
        vocab = engines[r.model].cfg.vocab_size
        assert all(0 <= t < vocab for t in r.request.output_tokens)
    missing = [n for n, c in launches.items() if c == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"

    # routing, in two checks on the same embeddings.  (a) The card's
    # serve_fused against the plain tail on the CPU fed with the kernel's
    # own neighbours: every row's choice, s_hat, c_hat, kth and agreement.
    # (b) The kernel's neighbours against the plain retrieval on the CPU.
    # The support holds near-duplicate rows (texts that differ in one
    # number), so the k-th neighbour can tie to ~1e-7 and the two may keep
    # different members of a tie: the scores must agree, and every id in
    # only one of the two sets must score within the tolerance of the k-th.
    t0 = time.perf_counter()
    emb = encoder.embed_texts(texts)
    t1 = time.perf_counter()
    out = svc.router.serve_fused(emb, lams)
    t2 = time.perf_counter()
    assert out[1].shape == (16, 2) and np.isfinite(out[1]).all()
    assert [svc.model_names[c] for c in out[0]] == [r.model for r in results]
    k_s, k_i = svc.router._neighbors(emb)
    plain = make_router("knn10", device="cpu").fit(ds)
    _, S_cpu, C_cpu = plain._support_dev()
    tail = [t.numpy() for t in _serve_tail(
        torch.from_numpy(k_s), torch.from_numpy(k_i), S_cpu, C_cpu,
        torch.from_numpy(lams), torch.ones(2, dtype=torch.bool),
        weights=plain.weights, temperature=float(plain.temperature))]
    route_err = max(float(np.abs(a - b).max())
                    for a, b in zip(out[1:], tail[1:]))
    # a choice may differ only where the two utilities tie
    util = tail[1] - lams[:, None] * tail[2]
    rows = np.arange(16)
    route_err = max(route_err, float(np.abs(
        util[rows, out[0]] - util[rows, tail[0]]).max()))
    p_s, p_i = plain._neighbors(emb)
    route_err = max(route_err, float(np.abs(k_s - p_s).max()))
    qn = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    same = np.array([set(a) == set(b) for a, b in zip(k_i, p_i)])
    for r in np.flatnonzero(~same):
        for i in set(k_i[r]) ^ set(p_i[r]):
            tie = abs(float(plain._X[i] @ qn[r]) - float(p_s[r, -1]))
            route_err = max(route_err, tie)
    assert route_err <= 1e-5, route_err

    # decoding: a reduced f32 engine on the card against the same weights
    # on the CPU (plain attention), greedy tokens equal
    cfg = reduced(get_config("h2o-danube-1.8b"))
    lm = M.init_params(cfg, seed=3, device="cpu")
    toks = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, params=copy.deepcopy(lm), max_slots=2,
                            cache_len=96, device=dev)
        reqs = [Request(uid=i, prompt_tokens=np.arange(5 + i) % 97 + 1,
                        max_new_tokens=80) for i in range(2)]
        eng.run_until_drained(reqs)
        toks[dev] = [r.output_tokens for r in reqs]
    assert toks["cuda"] == toks["cpu"], "greedy tokens differ from the CPU"
    emit("main_path_checks", embed_16_texts_s=t1 - t0,
         route_16_texts_s=t2 - t1, route_max_abs_err=route_err, route_tol=1e-5,
         route_choices_equal=int((out[0] == tail[0]).sum()),
         rows_with_tied_neighbour_swaps=int((~same).sum()),
         reduced_greedy_tokens_equal=True)
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    try:
        from repro_torch.kernels import _build
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: the port's package is missing next "
                         f"to this script ({exc})")

    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         tf32="off for matmul and cudnn")

    report = _build.build_all()
    emit("build", seconds=report.pop("total_s"), ptxas=report)

    main_cases = phase_kernels(torch)
    launches = {n: None for n in main_cases}
    if not args.kernels:
        launches = phase_main_path(torch)
    assert "jax" not in sys.modules and "repro" not in sys.modules

    kernels = []
    for name, r in main_cases.items():
        src, replaces = KERNEL_SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "case": r["case"]})
    emit("done", wall_s=time.perf_counter() - t_all)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
