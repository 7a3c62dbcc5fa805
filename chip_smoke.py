#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one GPU
    python3 chip_smoke.py --kernels  # phases 1-3 only (build + kernel checks)

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. device: the card's name and count, its power limit from nvidia-smi;
     TF32 is switched off for matmuls and convolutions, so f32 is f32.
  2. build: every CUDA kernel of the port compiled from this checkout's
     sources with nvcc (one process per source, all started together).
     The SSD kernels' SASS must hold tensor-core (HMMA) instructions.
  3. kernels: each kernel against its plain-torch version on the card at
     the serving path's shapes, with the max error against a stated
     tolerance, the kernel's, the plain version's and (where one PyTorch
     call computes the same function) the library call's time in ms, and
     the least time the card could take (bytes over 3.35 TB/s or flops over
     the dtype's peak, whichever is larger; f32 at the rate of f32-accurate
     tensor-core products, three TF32 passes).
     Kernels 4 and 5 (IVF scan, IVF-PQ ADC shortlist) run on synthetic
     indexes at the main path's shape (70,000 rows in 265 lists of 400,
     D 768, nprobe 8, k 100, kk 800, m 64) and at the edge cases: nbits 4,
     Q 1 and 64, nprobe = C, and lists holding fewer than k rows; kernel 5
     on the path its shape picks and, at the fused shapes, on the three
     launches too (`_adc_cuda`), and on the three launches as the shape's
     choice at nprobe = C of the 265 lists and at kk = 3,000 (nbits 8 and
     4, Q 1, 16 and 64).  Exact top-k also runs at N not a multiple of its
     tiles, Q = 1, ties across its tile and row-range borders, an
     all-equal support (the k > 128 overflow path) and a clustered one
     above k = 128 (the refined threshold; no query may overflow), each
     case called twice (bitwise-equal outputs).  The main cases of kernels
     1 and 5 (and exact top-k at Q 64 / k 100, k 100, k 200; ADC at
     kk 2,048 and on the three launches) are profiled: device time by CUDA
     launch inside one call, whose launches must equal the kernel
     library's count (one for exact top-k at k <= 128 and the fused
     shortlist).
  4. main path at full width: engines for qwen3-4b and h2o-danube-1.8b at
     their published widths in bf16 (seeded random weights), a 100,000-row
     support set embedded by the port's query encoder, and two paths over
     it, each with the kernels' launch counters zeroed just before and
     read just after:
     a. `knn10` (exact retrieval) serving 16 texts at per-request lambdas
        through `RouterService.serve_texts`.  The routing is checked
        against the plain tail on the CPU fed with the kernel's neighbours,
        the neighbours against the plain retrieval, and a reduced engine's
        greedy tokens against the same engine on the CPU.  The route of the
        16 texts is profiled (one launch of exact top-k).  Then one
        `torch.profiler` window of a short serve (4 texts, 4 new tokens):
        device time by kernel, decode attention's share, the idle share.
     b. `knn100-ivfpq` fitted through `RoutingPipeline`, saved, and a
        service re-booted from the artifact serving the same 16 texts;
        `knn100-ivf` routing the same embeddings.  Both IVF kernels must
        have run; the artifact service must choose as the in-memory one
        does; recall@100 against the exact kernel (at nprobe 8, 32 and C,
        with what the probe leaves reachable) and the choice agreement with
        exact `knn100` are printed; each route is profiled (one launch of
        exact top-k and of the fused ADC shortlist; a window that records
        none of the route's kernel is taken again, up to three times, and
        the run fails if none does), and the knn100-ivfpq route's
        shortlist must be bitwise equal on kernel 5's three launches (the
        parent design), so the route chooses and recalls alike on both.
        Kernels 4 and 5 are checked, timed and bounded again on the
        fitted index and the 16 embedded texts, and exact top-k at k 200
        and 1,024 on the embedded support (overflowed queries counted).
     Kernel 6 (the Mamba-2 SSD intra-chunk pass) and its gradient run at
     the training path's shape (batch 4 x 2,048: 8 chunks of 256, 32 heads
     of 64, state 128) and at two groups, Q = 12, S = 384 padded, H 12 in
     3 groups, H 6 in 1, Q = 200 and N 20 / P 24; exact
     top-k at k = 200, 1,024 and 2,048 (the keyed path; two selection
     rounds at 2,048) at the main path's shape, and kernels 4 and 5 at
     k = 2,048.  Decode attention runs at the span edges (positions 0,
     span - 1, span, S - 1, a slot with no valid key) and with spans of
     64 and 128 rows; flash attention at an S that is not a multiple of
     its 64-key tile.
  5. mamba2-370m (slice 3), at its published widths with seeded weights:
     a. `repro_torch.launch.train.main` trains 10 steps in bf16 (batch 4 x
        2,048, zipf stream) with the counters zeroed just before and read
        just after: the loss must stay finite and fall, and both SSD
        kernels must have run (>= 480 forward, 480 backward launches);
        then one step under `torch.profiler`.
     b. in f32, `forward` over 384 tokens against 384 `decode_step`s of
        the recurrence (rtol / atol 2e-3).
     c. a bf16 Mamba engine joins phase 4's engines as the reference's
        three-model pool behind `knn10` for the 16 texts; then 16 prompts
        admitted into its 4 slots while others are mid-stream must decode
        the tokens each decodes served alone.
  6. the gateway (slice 8): phase 4b's artifact-booted `knn100-ivfpq`
     service in the port's `Gateway` on 127.0.0.1 at an ephemeral port
     (max_batch 16, close timeout 10 ms, max_pending 32), the counters
     zeroed before each step and read after it:
     a. `/health` 200 "ok", `/v1/models` lists `repro/knn100-ivfpq`;
     b. one streamed request alone at `@lam=0.5`: its tokens and engine
        equal `serve_texts` of the same text;
     c. 16 concurrent streaming clients (phase 4's texts and lambdas, 8
        tokens): well-formed streams, each engine the one `route_fused`
        chooses, as many routes as flushes and fewer than 16, kernels 2, 3
        and 5 launched; TTFT p50 / p99 from `/stats`;
     d. a second gateway with max_pending 2 over engines slowed by
        `FaultInjector("latency")`: 429 with `Retry-After` past the bound;
     e. qwen3-4b raising (`FaultInjector("raise")`) behind a second
        service with its own breakers: its requests served by the other
        engine with `rerouted_from`, `/health` 503 while the breaker is
        open, the next wave routed around it, 200 after `heal()` and the
        backoff;
     f. `route_fused(degrade=1..3)` on `knn100-ivf` and `knn100-ivfpq`:
        the kernel's neighbours against the plain versions on the card at
        the degraded nprobe / rerank and the same probe, choices against
        the plain tail on the CPU fed with the kernel's neighbours,
        nprobe / rerank restored;
     g. one full wave of 16 through phase 4a's `knn10` service;
     h. every gateway closed: threads joined, ports dark.  The phase
        must finish in 120 s.
  7. streaming and recovery (slice 9, `phase_streaming`; 150 s budget).
  8. the paper's evaluation (slice 10, `phase_evaluation`; 150 s budget):
     the seeded suite; Table 2's protocol through
     `RoutingPipeline(spec, seed=0).fit(ds).evaluate()` for the 12 routers
     of `PAPER_ORDER` on three columns and `knn10` / `knn100` / `linear` on
     the other seven; Table 5's first column (D = 3,584); Table D's
     `selection_utility`; every router held against the CPU path, every
     kNN AUC in (random, oracle], every trained fit's loss falling, every
     self-query of kernel 1 against its plain version, and no plain
     version of kernel 1 reached with a CUDA tensor.  Phase 3 runs kernel
     1 at this phase's shapes too (the self-query at Q = N = 1,400 and
     5,040, and Q 300 x N 1,050 at D 3,584).
  9. the other text families (slice 11, `phase_families`; 150 s budget):
     a. `repro_torch.launch.train.main --arch h2o-danube-1.8b` at its
        published widths and depth in bf16: 10 steps of batch 2 x 4,096
        (the reference's TRAIN_4K length, hd 80, window 4,096, 24 layers,
        remat), counters zeroed before and read after: the loss finite
        and falling, kernel 2 >= 2 x 24 x 10 launches and kernel 2b (the
        flash backward) >= 24 x 10, no plain attention reached with a CUDA
        tensor; `--ckpt` (the reference's layout) read back through the
        port's reader, bitwise equal; one step under `torch.profiler`
        (device time by kernel, idle share).
     b. one model at a time at its published widths in bf16, seeded, freed
        before the next: zamba2-7b at full depth (81 layers, the shared
        block at hd 112), starcoder2-15b at 8 of 40 layers, qwen1.5-32b at
        8 of 64, deepseek-v2 at 2 of 60 (MLA + 160 experts), llama4-
        maverick at 1 of 24 groups (one dense and one MoE layer): `forward`
        over 256 tokens against 256 teacher-forced `decode_step`s (relative
        L2 of each position's logits <= 0.25), a `ServingEngine` serving 4
        prompts x 8 tokens, kernels 2 and 3 (and 6 for zamba2) launched,
        MoE's dropped slots and the peak memory printed.
     Phase 3 runs kernel 2b at 9a's shape and at head dims 64, 80, 112 and
     128, G 1, 5 and 12, causal, windowed and non-causal, S not a multiple
     of its tiles, f32 and bf16, with and without a KV head's query heads
     split over blocks (`kv_splits`), each against autograd through the
     plain version and SDPA's backward; and kernels 2 and 3 at hd 112.  The
     build line counts the tensor-core instructions of kernel 2b's dQ /
     dK-dV kernel (HMMA.16816 in bf16, HMMA.1688 in f32) at each head dim.
 10. the vision and audio front ends (slice 13, `phase_front_ends`; 120 s
     budget), the counters zeroed before each part and read after it:
     a. seamless-m4t-medium at its published widths and depth (12 encoder,
        12 decoder layers) in f32, seeded weights and N(0, 1) frames
        (1 x 1,500 x 1,024): `forward` over 256 tokens against
        `fill_cross_cache` and 256 teacher-forced `decode_step`s (the
        cross K / V cached, kernel 3 at position 1,499), the first 32 steps
        of the recompute path (kernel 2 at Sq 1 from ``enc_out``) against
        the cached path, both within phase 9's f32 limit; kernels 2 and 3
        launched as the layers count; then a bf16 forward's wall and peak
        memory.
     b. seamless trains 10 steps of `make_train_step` in bf16 with remat,
        batch 2 x (2,048 frames + 2,048 tokens), seeded N(0, 1) frames,
        under `refuse_plain_on_cuda`: the loss finite and falling, kernel 2
        720 launches and kernel 2b 360 (36 attention layers: encoder, self,
        cross), step wall, tokens/s, peak memory, one profiled step; then
        `launch.train.main --arch seamless-m4t-medium --steps 2 --ckpt`,
        the checkpoint read back bitwise.
     c. internvl2-76b at 8 of 80 layers served as 9b serves its models
        (the f32 check, a bf16 engine), a bf16 forward over 256 N(0, 1)
        patches (3,200 wide) and 256 tokens, and the patch-prefixed
        forward at 2 layers in f32 against the same weights through the
        plain attention on the card, within phase 9's f32 limit.
     Phase 3 runs the cross shapes too: kernels 2 and 2b at seamless's
     heads (H = KV = 16, hd 64), no mask, at B 2 / Sq 2,048 / Sk 1,500,
     B 4 / Sq 1 / Sk 1,500 and B 1 / Sq 96 / Sk 40, in f32 and bf16, and
     kernel 3 over 1,500 cache rows with every slot at position 1,499.
 11. the tooling (slice 14, `phase_tooling`; 60 s budget), after phase 10
     on phase 4's encoder and routers (kept when the engines are freed):
     a. the port's lint (`repro_torch.analysis.lint`) over src/repro_torch:
        0 findings, an empty baseline;
     b. `route_fused` of the 16 texts on `knn10`, `knn100-ivf` and
        `knn100-ivfpq` under `SyncCounter` with no other thread alive: the
        syncs by `path:line`, every one on an allow-host line; then five
        more waves of each under `CacheCounter`: no cache grows;
     c. `autotune_router` on the two IVF routers at Q 16 (the served
        texts) and 64 (the same request template, 64 texts): on
        `knn100-ivf` kernel 4 alone at block_q 8 / 16 / 32 / 64 by CUDA
        events (every candidate's neighbours bitwise equal), on
        `knn100-ivfpq` the one search (kernel 5 has no tile; its shape
        picks its path), each candidate's p50 and roofline terms; Q 16's
        tiles in a `DispatchPolicy` saved with the artifact, loaded back
        and routed: equal decisions, the chosen tile launched, kernel 5's
        fused launch kept;
     d. `autotune_lane_pad` (8, 128) on 20,000 rows of the support.
     Phase 3 runs kernel 4 at query tiles 8, 16, 32 and 64 on its cases (Q
     1, 16, 17, 64, 16 queries on one probe set, k 2,049, the delta tiers;
     phase 4b on the fitted index): each tile bitwise equal to 16, its ms
     and bound, and ptxas's registers and spills per instantiation.
The line before the last is the kernels' JSON summary, the last line the
device record.  Its cases are the main path's: for kernels 4 and 5 the
fitted phase-4 index (the synthetic one with --kernels); kernel 6's
launches are read on phase 5a's training path, kernel 2b's on phase 9a's
(phase 10's launches are in its own lines).
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

KERNEL_SOURCES = {
    "knn_topk": ("src/repro_torch/kernels/knn_topk/kernel.cu",
                 "src/repro/kernels/knn_topk/kernel.py:79"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/kernel.cu",
                        "src/repro/kernels/flash_attention/kernel.py:90"),
    # the gradient of kernel 2: the JAX trainer differentiates the jnp
    # `attend_ref` (src/repro/models/attention.py:66) that kernel 2 computes
    "flash_attention_bwd": (
        "src/repro_torch/kernels/flash_attention/bwd_kernel.cu",
        "src/repro/kernels/flash_attention/kernel.py:90"),
    "decode_attention": ("src/repro_torch/kernels/decode_attention/kernel.cu",
                         "src/repro/kernels/decode_attention/kernel.py:63"),
    "ivf_topk": ("src/repro_torch/kernels/knn_ivf/kernel.cu",
                 "src/repro/kernels/knn_ivf/kernel.py:65"),
    "ivfpq_adc": ("src/repro_torch/kernels/knn_ivf/pq_kernel.cu",
                  "src/repro/kernels/knn_ivf/pq_kernel.py:114"),
    "ssd_intra": ("src/repro_torch/kernels/ssd_scan/kernel.cu",
                  "src/repro/kernels/ssd_scan/kernel.py:59"),
    # the gradient of kernel 6: the JAX trainer differentiates the jnp SSD
    # whose intra-chunk part the kernel computes (ref.py:27-82)
    "ssd_intra_bwd": ("src/repro_torch/kernels/ssd_scan/bwd_kernel.cu",
                      "src/repro/kernels/ssd_scan/kernel.py:59"),
}
#: the main path's retrieval shape: 16 texts against the 70,000-row train
#: split of a 100,000-row support set, ~sqrt(N) = 265 lists, lists capped at
#: 1.5 N / C = 397 rows (L = 400 after rounding to 8), nprobe 8, D = 768;
#: knn100 keeps k = 100 and re-ranks an ADC shortlist of 8 k = 800
IVF_MAIN = dict(N=70_000, C=265, L=400, D=768, Q=16, P=8, k=100, kk=800,
                m=64)
#: seamless-m4t-medium's cross attention (phase 10) in phase 3, H = KV =
#: 16, hd 64, no mask, as (B, Sq, Sk): 2,048 decoder tokens over a
#: 1,500-row encoder output (phase 10a's frames), the recompute decode's
#: one query row, and keys under one 64-row tile
CROSS_SHAPES = [(2, 2048, 1500), (4, 1, 1500), (1, 96, 40)]
#: the engine-wave deadline of the served services (phases 4b and 6): a
#: wave of 16 texts takes seconds at full width, so only a hung engine
#: reaches it
ENGINE_TIMEOUT_S = 300.0


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def case_gen(torch, seed, *key):
    """A generator of its own for one phase-3 case, seeded from the run's
    ``--seed`` and the case's parameters (``key``), so no case's inputs
    depend on which cases drew before it."""
    h = zlib.crc32(repr(key).encode())
    return torch.Generator(device="cuda").manual_seed(seed * 2**32 + h)


def bound(nbytes, flops, dtype):
    """The least ms the card could take: bytes over its HBM rate or
    operations over the dtype's peak (`repro_torch.launch.mesh`, the one
    copy of the card's constants), whichever is larger."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS
    t_bytes = nbytes / HBM_BW * 1e3
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

def knn_case(torch, timer, Q, N, D, k, dtype, tol, gen, profile=False,
             kind="gaussian", q=None, s=None):
    """Exact top-k against its plain version.  ``kind``: a gaussian
    support, "border ties" (row 0 copied every 530 rows and at rows 63-65,
    across the 64-row tiles and the blocks' row ranges), "all equal" (ties
    everywhere; above k = 128 its candidates overflow the buffer and the
    full-key path answers), "clustered" (near-duplicates of one row, with
    queries near them: the cosines crowd a few exponents, so above k = 128
    the threshold takes refine digits) or, with ``q`` and ``s`` given,
    a label for those inputs.  Tied scores must come in row-id order, and a
    second call must return the same bits (the one-launch path's ticket
    counter is reset by its last block).  Above k = 128 the queries whose
    candidates overflowed are counted; the synthetic supports other than
    the all-equal one must not overflow.  ``profile`` adds one profiled
    call: device time by CUDA launch inside the call."""
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_reference
    if s is None:
        q = torch.randn(Q, D, device="cuda", generator=gen)
        s = torch.randn(N, D, device="cuda", generator=gen)
        if kind == "border ties":
            s[::530] = s[0]
            s[63:66] = s[0]
        elif kind == "all equal":
            s[:] = s[0]
        elif kind == "clustered":
            s = s[0] + 0.2 * s / math.sqrt(D)
            q = s[:Q] + 0.5 * q / math.sqrt(D)
        elif kind == "self query":
            q = s[:Q].clone()
        q = q / q.norm(dim=1, keepdim=True)
        s = s.to(dtype)
    out_s, out_i = knn_topk(q, s, k)
    cuda_launches = knn_topk.last_cuda_launches
    flags = knn_topk.last_overflow
    again = knn_topk(q, s, k)
    ref_s, ref_i = knn_topk_reference(q, s, k)
    torch.cuda.synchronize()
    assert torch.equal(out_s, again[0]) and torch.equal(out_i, again[1]), \
        "a second call returned other bits"
    same = (out_s[:, 1:] == out_s[:, :-1]) & (out_i[:, 1:] >= 0)
    assert bool((out_i[:, 1:][same] > out_i[:, :-1][same]).all()), \
        "tied scores out of row-id order"
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
    out = dict(case=f"Q={Q} N={N} D={D} k={k} {str(dtype)[6:]}"
                    + ("" if kind == "gaussian" else f" {kind}"),
               max_abs_err=max(err, id_err), tol=tol, ms=ms, plain_ms=plain,
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               repeat_bitwise_equal=True, cuda_launches=cuda_launches)
    if kind == "self query":
        # the graph / attentive fits drop each row's first neighbour
        rows = torch.arange(Q, device=out_i.device)
        out["self_top1_share"] = float((out_i[:, 0] == rows).float().mean())
        out["self_top1_share_plain"] = float(
            (ref_i[:, 0] == rows).float().mean())
    if k <= 128:
        assert cuda_launches == 1, cuda_launches
    else:
        out["overflowed_queries"] = int(flags.sum())
        if kind in ("gaussian", "border ties", "clustered"):
            assert out["overflowed_queries"] == 0, out
    if profile:
        # the profile's launches inside one call: one kernel, the scan,
        # for k <= 128
        p = out["launch_profile"] = device_profile(
            torch, lambda: knn_topk(q, s, k), top=6,
            groups={"knn_topk": "knn_"}, require="knn_topk",
            library_count=lambda: knn_topk.last_cuda_launches)
        if k <= 128 and "not_measured" not in p:
            assert p["device_launches"] == p["knn_topk"]["count"] == 1, p
    return out


def attn_err(torch, out, ref, tol, dtype):
    """An attention kernel's output against the plain version's f32 result
    on the same input values.  Returns the largest |out - ref|, the largest
    ratio of |out - ref| to its limit (<= 1 passes) and |ref| where that
    ratio peaks.  The limit is ``tol``; for a bf16 output it rises to
    bf16's own rounding bound, 2^-8 |ref| plus the f32 limit 2e-5, where
    that is larger (|ref| > 2.55): no bf16 output lies closer to the f32
    value than its rounding, half a bf16 step, 0.0156 for |ref| in [4, 8)."""
    d = (out.float() - ref).abs()
    lim = torch.full_like(ref, tol)
    if dtype == torch.bfloat16:
        lim = torch.maximum(lim, ref.abs() * 2.0 ** -8 + 2e-5)
    r = (d / lim).flatten()
    i = int(r.argmax())
    return float(d.max()), float(r[i]), float(ref.abs().flatten()[i])


def live_pairs(Sq, Sk, causal, window):
    n = 0
    for i in range(Sq):
        lo = max(0, i - window + 1) if window else 0
        hi = min(Sk, i + 1) if causal else Sk
        n += max(0, hi - lo)
    return n


def flash_case(torch, timer, B, S, H, KV, hd, dtype, causal, window, tol,
               gen, Sk=None):
    """Kernel 2 against the plain version on the same values; S query rows
    against ``Sk`` keys (S by default; a cross attention's encoder rows)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_reference)
    Sk = S if Sk is None else Sk
    q = torch.randn(B, S, H, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, Sk, KV, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, Sk, KV, hd, device="cuda", generator=gen).to(dtype)
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention_reference(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
    torch.cuda.synchronize()
    err, ratio, ref_at = attn_err(torch, out, ref, tol, dtype)
    ref_std = float(ref.std())
    assert ratio <= 1.0, (err, ratio, ref_at, tol)
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
    b_ms, b_by = bound(2 * (B * S * H * hd + B * Sk * KV * hd) * esz,
                       4 * B * H * hd * live_pairs(S, Sk, causal, window),
                       dtype)
    sk = f" Sk={Sk}" if Sk != S else ""
    return dict(case=f"B={B} S={S}{sk} H={H} KV={KV} hd={hd} "
                     f"{str(dtype)[6:]} causal={causal} window={window}",
                max_abs_err=err, err_over_tol=ratio, ref_at_worst=ref_at,
                tol=tol, ref_std=ref_std, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def grad_err(torch, out, ref, dtype):
    """A gradient of kernel 2b against the plain version's f32 gradient on
    the same input values: the largest |out - ref| and its largest ratio
    to the limit (<= 1 passes): f32 2e-5 + 1e-5 |ref|; bf16 1e-2, or
    bf16's own rounding 2^-8 |ref| + 2e-5 where larger (`attn_err`)."""
    d = (out.float() - ref).abs()
    if dtype == torch.bfloat16:
        lim = torch.maximum(torch.full_like(ref, 1e-2),
                            ref.abs() * 2.0 ** -8 + 2e-5)
    else:
        lim = 2e-5 + 1e-5 * ref.abs()
    return float(d.max()), float((d / lim).max())


def flash_bwd_case(torch, timer, B, S, KV, G, hd, dtype, causal, window,
                   gen, Sk=None):
    """Kernel 2b (dQ, dK, dV from the forward's f32 out and log-sum-exp)
    against autograd through the plain version in f32 on the same values
    (`grad_err`), called twice (bitwise-equal: no atomics).  Timed alone
    (the forward not included); the library time is the backward of
    `scaled_dot_product_attention` at the same shape (a boolean mask where
    the window is shorter than S).  Bound: the bytes of q, k, v, dO, the
    f32 o and lse read and dq, dk, dv written once, or 10 B H hd flops a
    live pair (S, dP, dV, dK, dQ) at the dtype's peak.  ``Sk`` keys (S by
    default) against S query rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain)
    H = KV * G
    Sk = S if Sk is None else Sk
    q = torch.randn(B, S, H, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, Sk, KV, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, Sk, KV, hd, device="cuda", generator=gen).to(dtype)
    do = torch.randn(B, S, H, hd, device="cuda", generator=gen).to(dtype)
    _, lse, out32 = fops._forward(q, k, v, causal, window, True)
    bwd = lambda: fops.flash_attention_bwd(q, k, v, do, causal=causal,
                                           window=window, out=out32, lse=lse)
    got, again = bwd(), bwd()
    ref = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                    do.float(), causal=causal, window=window)
    torch.cuda.synchronize()
    errs = [grad_err(torch, a, r, dtype) for a, r in zip(got, ref)]
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "a second backward returned other bits"
    ratio = max(e[1] for e in errs)
    assert ratio <= 1.0, errs
    ref_std = [float(r.std()) for r in ref]
    del ref, again
    ms = timer(bwd)
    plain_ms = timer(lambda: flash_attention_bwd_plain(
        q, k, v, do, causal=causal, window=window), iters=3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    kw = dict(enable_gqa=KV != H)
    if window and window < S:
        i = torch.arange(S, device="cuda")
        m = (i[:, None] - i[None, :] < window)
        if causal:
            m &= i[:, None] >= i[None, :]
        kw["attn_mask"] = m
    else:
        # (causal only where Sk == S: no case masks a cross attention)
        kw["is_causal"] = causal
    lo = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    dot = do.transpose(1, 2)
    lib = timer(lambda: torch.autograd.grad(lo, (qt, kt, vt), dot,
                                            retain_graph=True))
    esz = q.element_size()
    nbytes = (2 * B * S * H * hd + 2 * B * Sk * KV * hd) * esz \
        + (B * S * H * hd + B * H * S) * 4 \
        + (B * S * H * hd + 2 * B * Sk * KV * hd) * esz
    b_ms, b_by = bound(nbytes, 10 * B * H * hd * live_pairs(S, Sk, causal,
                                                            window), dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sk = f" Sk={Sk}" if Sk != S else ""
    return dict(case=f"B={B} S={S}{sk} H={H} KV={KV} G={G} hd={hd} "
                     f"{str(dtype)[6:]} causal={causal} window={window}",
                kv_splits=fops.kv_splits(B, Sk, KV, G, sms),
                max_abs_err=max(e[0] for e in errs), err_over_tol=ratio,
                err_by_output=dict(zip(("dq", "dk", "dv"),
                                       [e[1] for e in errs])),
                ref_std=ref_std, tol="f32 2e-5 + 1e-5 |ref|; bf16 1e-2 "
                "or 2^-8 |ref| + 2e-5", repeat_bitwise_equal=True, ms=ms,
                plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)


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
    ref = decode_attention_reference(q.float(), ck.float(), cv.float(), p,
                                     ring=ring)
    torch.cuda.synchronize()
    err, ratio, ref_at = attn_err(torch, out, ref, tol, dtype)
    ref_std = float(ref.std())
    assert ratio <= 1.0, (err, ratio, ref_at, tol)
    assert all(bool((out[b] == 0).all()) for b in range(B) if pos[b] < 0)
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
                max_abs_err=err, err_over_tol=ratio, ref_at_worst=ref_at,
                tol=tol, ref_std=ref_std, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def ssd_case(torch, timer, Bs, H, nc, Q, P, G, N, valid, gen, label,
             profile=False):
    """Kernel 6 and its gradient against their plain versions evaluated in
    float64 on the same f32 inputs, rtol / atol 3e-4 (the reference's SSD
    kernel test).  The f32 plain version is not the yardstick: gA sums
    terms far larger than itself, and in f32 the plain version's gA can
    miss that tolerance by several times (`bwd_kernel.cu`, which sums them
    in f64); its distance to float64 is printed beside the check
    (``plain_f32_err_over_tol``).  ``valid`` zeroes the rows at or past
    it, as `ssm_full` pads a short tail.  Bounds count each input read
    once, each output written once, and the products the function needs:
    the Q (Q + 1) / 2 causal (i, j) pairs of a chunk, with C B^T and the
    group's sums (gC, gB) once per group, not per head.  ``profile`` adds
    one profiled call of each direction: device time by CUDA launch inside
    the call (C B^T, the heads' passes, the group's sums)."""
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_bwd, ssd_intra_fwd
    from repro_torch.kernels.ssd_scan.ref import (ssd_intra_bwd_plain,
                                                  ssd_intra_plain)
    f = lambda *sh: torch.randn(*sh, device="cuda", generator=gen)
    x, dt = f(Bs, H, nc, Q, P), torch.nn.functional.softplus(
        f(Bs, H, nc, Q, 1))
    A = -torch.exp(f(H) * 0.3)
    Bm, Cm = f(Bs, G, nc, Q, N) * 0.3, f(Bs, G, nc, Q, N) * 0.3
    if valid is not None:
        keep = (torch.arange(nc * Q, device="cuda").reshape(nc, Q)
                < valid).float()[..., None]
        x, dt, Bm, Cm = x * keep, dt * keep, Bm * keep, Cm * keep
    gy, gst, gcs = f(Bs, H, nc, Q, P), f(Bs, H, nc, P, N), f(Bs, H, nc, Q, 1)
    ins = [t.contiguous() for t in (x, dt, A, Bm, Cm)]
    out = ssd_intra_fwd(*ins)
    ref = ssd_intra_plain(*ins)
    g = ssd_intra_bwd(*ins, ref[2], gy, gst, gcs)
    gr = ssd_intra_bwd_plain(*ins, ref[2], gy, gst, gcs)
    f64 = lambda ts: [t.double() for t in ts]
    exact = (ssd_intra_plain(*f64(ins)),
             ssd_intra_bwd_plain(*f64((*ins, ref[2], gy, gst, gcs))))
    torch.cuda.synchronize()

    # max abs error, and the largest |kernel - exact| / (atol + rtol |exact|)
    # (<= 1 passes): gradients such as gA reach 1e3-1e4, so their absolute
    # error says little alone
    def worst(a, b):
        e, rs = 0.0, []
        for u, v in zip(a, b):
            assert u.shape == v.shape
            d = (u.double() - v.double()).abs()
            e = max(e, float(d.max()))
            rs.append(float((d / (3e-4 + 3e-4 * v.double().abs())).max()))
        return e, rs
    errs, ratios, by_output, plain_f32 = [], [], [], []
    for a, b, c, names in ((out, ref, exact[0], ("y", "states", "cs")),
                           (g, gr, exact[1], ("gx", "gdt", "gA", "gB",
                                              "gC"))):
        e, rs = worst(a, c)
        assert max(rs) <= 1.0, (label, e, dict(zip(names, rs)))
        errs.append(e)
        ratios.append(max(rs))
        by_output.append(dict(zip(names, rs)))
        plain_f32.append(max(worst(b, c)[1]))
    del gr, exact
    fwd_ms = timer(lambda: ssd_intra_fwd(*ins))
    fwd_plain = timer(lambda: ssd_intra_plain(*ins), iters=3)
    bwd_ms = timer(lambda: ssd_intra_bwd(*ins, ref[2], gy, gst, gcs))
    bwd_plain = timer(lambda: ssd_intra_bwd_plain(*ins, ref[2], gy, gst,
                                                  gcs), iters=3)
    heads, groups, pairs = Bs * H * nc, Bs * G * nc, Q * (Q + 1) // 2
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    f_ms, f_by = bound(nbytes(*ins, *out),
                       groups * pairs * 2 * N
                       + heads * (pairs * 2 * P + 2 * Q * P * N),
                       torch.float32)
    b_ms, b_by = bound(nbytes(*ins, ref[2], gy, gst, gcs, *g),
                       groups * pairs * 6 * N
                       + heads * (pairs * 4 * P + 4 * Q * P * N),
                       torch.float32)
    case = f"{label}: B={Bs} H={H} nc={nc} Q={Q} P={P} G={G} N={N}" + (
        f" valid={valid}" if valid is not None else "")
    common = dict(case=case, tol="rtol 3e-4, atol 3e-4 to float64",
                  library_ms=None)
    if profile:
        common["launch_profile"] = dict(
            forward=device_profile(torch, lambda: ssd_intra_fwd(*ins), top=4),
            gradient=device_profile(torch, lambda: ssd_intra_bwd(
                *ins, ref[2], gy, gst, gcs), top=6))
    return (dict(common, max_abs_err=errs[0], err_over_tol=ratios[0],
                 err_over_tol_by_output=by_output[0],
                 plain_f32_err_over_tol=plain_f32[0],
                 ms=fwd_ms, plain_ms=fwd_plain, bound_ms=f_ms, bound_by=f_by),
            dict(common, max_abs_err=errs[1], err_over_tol=ratios[1],
                 err_over_tol_by_output=by_output[1],
                 plain_f32_err_over_tol=plain_f32[1],
                 ms=bwd_ms, plain_ms=bwd_plain, bound_ms=b_ms, bound_by=b_by))


def phase_ssd_kernels(torch, timer, gen):
    """Kernel 6 and its gradient at the training path's shape (batch 4 of
    2,048 tokens: 8 chunks of 256, 32 heads of 64, state 128, one group),
    then two groups, a chunk shorter than a tile (Q = 12), S = 384 padded
    by `ssm_full` to two chunks of 256, four heads a group (H 12, G 3),
    six heads a group (H 6, G 1: not a power of two), a ragged chunk
    (Q = 200) and N, P that are not multiples of 8 (N 20, P 24)."""
    main = {}
    for i, args in enumerate([
            (4, 32, 8, 256, 64, 1, 128, None, "main"),
            (2, 32, 2, 256, 64, 2, 128, None, "G=2"),
            (2, 32, 1, 12, 64, 1, 128, None, "Q=12"),
            (2, 32, 2, 256, 64, 1, 128, 384, "S=384 padded"),
            (2, 12, 2, 256, 64, 3, 128, None, "H=12 G=3"),
            (2, 6, 2, 256, 64, 1, 128, None, "H=6 G=1"),
            (2, 8, 2, 200, 64, 2, 128, None, "Q=200"),
            (2, 8, 2, 256, 24, 2, 20, None, "N=20 P=24")]):
        fwd, bwd = ssd_case(torch, timer, *args[:8], gen("ssd", *args),
                            args[8], profile=i == 0)
        emit("kernel", name="ssd_intra", **fwd)
        emit("kernel", name="ssd_intra_bwd", **bwd)
        if i == 0:
            main.update(ssd_intra=fwd, ssd_intra_bwd=bwd)
    return main


def phase_kernels(torch, seed):
    """Every kernel against its plain version at the main path's shapes and
    the edge cases; each case draws its inputs from a generator of its own
    (`case_gen`)."""
    timer = Timer(torch)
    gen = lambda *key: case_gen(torch, seed, *key)
    f32, bf16 = torch.float32, torch.bfloat16
    main = {}
    # knn: the main path's shape first (16 texts against the 70,000-row
    # train split of 100,000 support rows), then the wider cases, then the
    # keyed pass above k = 128 and the shared selection, in two rounds at
    # k = 2,048
    # then N not a multiple of the 64-row tile or of the row ranges,
    # Q = 1, the knn100 route's k, ties across tile and range borders, an
    # all-equal support on both paths (its k > 128 candidates overflow), and
    # a clustered support above k = 128 (the refined threshold)
    for i, (Q, N, k, dt, tol, kind) in enumerate([
            (16, 70_000, 10, f32, 1e-5, "gaussian"),
            (64, 100_000, 10, f32, 1e-5, "gaussian"),
            (64, 100_000, 100, f32, 1e-5, "gaussian"),
            (33, 100_003, 100, f32, 1e-5, "gaussian"),
            (7, 50, 64, f32, 1e-5, "gaussian"),
            (64, 100_000, 10, bf16, 1e-4, "gaussian"),
            (16, 70_000, 200, f32, 1e-5, "gaussian"),
            (16, 70_000, 1024, f32, 1e-5, "gaussian"),
            (16, 70_000, 2048, f32, 1e-5, "gaussian"),
            (1, 70_001, 10, f32, 1e-5, "gaussian"),
            (16, 70_000, 100, f32, 1e-5, "gaussian"),
            (16, 70_000, 10, f32, 1e-5, "border ties"),
            (16, 70_000, 300, f32, 1e-5, "border ties"),
            (4, 20_000, 100, f32, 1e-5, "all equal"),
            (4, 20_000, 300, f32, 1e-5, "all equal"),
            (16, 70_000, 200, f32, 1e-5, "clustered"),
            (16, 70_000, 1024, f32, 1e-5, "clustered")]):
        key = ("knn", Q, N, k, str(dt)) + (() if kind == "gaussian"
                                           else (kind,))
        r = knn_case(torch, timer, Q, N, 768, k, dt, tol, gen(*key),
                     profile=i in (0, 2, 6, 10), kind=kind)
        emit("kernel", name="knn_topk", **r)
        if i == 0:
            main["knn_topk"] = r
    # the evaluation's shapes (phase 8): the graph and attentive fits'
    # self-queries (Q = N = the train split of a text column at k 11 / 101,
    # of RouterBench at k 11), and the VLM column (D = 3,584)
    for Q, N, D, k, kind in [(1400, 1400, 768, 11, "self query"),
                             (1400, 1400, 768, 101, "self query"),
                             (5040, 5040, 768, 11, "self query"),
                             (300, 1050, 3584, 100, "gaussian")]:
        r = knn_case(torch, timer, Q, N, D, k, f32, 1e-5,
                     gen("knn", Q, N, D, k, kind), kind=kind)
        emit("kernel", name="knn_topk", **r)
    # flash: the query encoder's shape (a chunk of 1024 texts), then bf16
    # GQA with hd=128 and a window, danube's hd=80, S that are not a
    # multiple of the 64-key tile, and one key tile of 40 keys in bf16 with
    # GQA and a window.  The plain versions compute in f32 and round to q's
    # dtype last; a bf16 kernel output is held against that f32 result (the
    # plain version on the same values in f32), since two results rounded
    # to bf16 apart can differ by a whole bf16 step.  The bf16 limit (1e-2,
    # raised to bf16's own rounding where |o| > 2.55: `attn_err`) sits well
    # below the outputs' own spread (ref_std), so a dropped KV tile fails
    # the check.
    for i, args in enumerate([
            (1024, 64, 12, 12, 64, f32, True, 0, 2e-5),
            (4, 1024, 32, 8, 128, bf16, True, 256, 1e-2),
            (2, 256, 32, 8, 80, f32, True, 64, 2e-5),
            (8, 100, 12, 4, 64, f32, True, 0, 2e-5),
            (2, 200, 8, 8, 128, f32, False, 0, 2e-5),
            (256, 40, 16, 4, 128, bf16, True, 16, 1e-2),
            # zamba2-7b's shared block: hd 3,584 / 32 = 112, G 1
            (2, 512, 32, 32, 112, bf16, True, 0, 1e-2),
            (1, 150, 32, 32, 112, f32, True, 0, 2e-5)]):
        r = flash_case(torch, timer, *args,
                       gen=gen("flash", *args[:5], str(args[5]), *args[6:8]))
        emit("kernel", name="flash_attention", **r)
        if i == 0:
            main["flash_attention"] = r
    # cross attention (phase 10): seamless-m4t-medium's heads, no mask,
    # Sq != Sk, in f32 and bf16
    for B, Sq, Sk in CROSS_SHAPES:
        for dt, tol in ((f32, 2e-5), (bf16, 1e-2)):
            r = flash_case(torch, timer, B, Sq, 16, 16, 64, dt, False, 0,
                           tol, gen=gen("flash_cross", B, Sq, Sk, str(dt)),
                           Sk=Sk)
            emit("kernel", name="flash_attention", cross=True, **r)
    # decode: qwen3-4b's decode shape, danube's hd=80 ring past S, then the
    # span edges of the 64-row spans (0, one span - 1, one span, S - 1) and
    # slots with no valid key
    for i, args in enumerate([
            ([100, 511, 7, 300], 512, 8, 4, 128, bf16, False, 1e-2),
            ([700, 511, 1030, 5], 512, 8, 4, 80, bf16, True, 1e-2),
            ([700, 63, 64, 0], 64, 2, 2, 64, f32, True, 2e-5),
            ([0, 63, 64, 511], 512, 8, 4, 128, bf16, False, 1e-2),
            ([-1, 127, 128, 300], 512, 8, 4, 128, bf16, True, 1e-2),
            ([-1, 64, 65, 99], 100, 8, 4, 64, f32, False, 2e-5),
            # hd 112 (zamba2-7b's shared block, G 1) in both cache modes
            ([100, 511, 7, 300], 512, 32, 1, 112, bf16, False, 1e-2),
            ([700, 63, 64, 0], 256, 32, 1, 112, f32, True, 2e-5)]):
        r = decode_case(torch, timer, *args,
                        gen=gen("decode", *args[:5], str(args[5]), args[6]))
        emit("kernel", name="decode_attention", **r)
        if i == 0:
            main["decode_attention"] = r
    # the cached cross decode (phase 10a): every slot at position Se - 1
    # over seamless's 1,500 encoder rows
    for dt, tol in ((bf16, 1e-2), (f32, 2e-5)):
        r = decode_case(torch, timer, [1499] * 4, 1500, 16, 1, 64, dt, False,
                        tol, gen=gen("decode_cross", str(dt)))
        emit("kernel", name="decode_attention", cross=True, **r)
    main.update(phase_ivf_kernels(torch, timer, gen))
    phase_delta_kernels(torch, timer, gen)
    main.update(phase_ssd_kernels(torch, timer, gen))
    # kernel 2b, last (its SDPA-backward timings after every profiled
    # case): danube's training shape (phase 9a's), then head dims 64,
    # 80, 112 and 128, G 1, 5 and 12, causal, windowed (window < S) and
    # non-causal, S not a multiple of the 64-row tiles, f32 and bf16
    for i, args in enumerate([
            (2, 4096, 8, 4, 80, bf16, True, 4096),
            (2, 130, 2, 1, 64, f32, True, 0),
            (1, 200, 1, 5, 80, f32, True, 48),
            (1, 100, 1, 12, 112, f32, False, 0),
            (1, 257, 2, 1, 128, f32, True, 64),
            (1, 333, 1, 5, 64, f32, False, 40),
            (2, 130, 2, 5, 112, bf16, True, 0),
            (1, 300, 1, 12, 128, bf16, True, 100),
            (2, 96, 2, 1, 80, bf16, False, 0),
            (1, 1000, 4, 12, 128, bf16, True, 0),
            (2, 512, 32, 1, 112, bf16, True, 0),
            # the tensor-core design's edges: hd 112 windowed with S not a
            # multiple of 64; 8 query tiles x 3 heads through the two-stage
            # ring of one dkdv block, ragged last tile; G 12 over 12 blocks
            # (kv_splits) in f32
            (1, 333, 2, 4, 112, bf16, True, 100),
            (1, 450, 1, 3, 80, f32, True, 0),
            (1, 300, 1, 12, 64, f32, True, 0)]):
        r = flash_bwd_case(torch, timer, *args,
                           gen=gen("flash_bwd", *args[:5], str(args[5]),
                                   *args[6:]))
        emit("kernel", name="flash_attention_bwd", **r)
        if i == 0:
            main["flash_attention_bwd"] = r
    # the gradient of the cross attention (phase 10b trains through it)
    for B, Sq, Sk in CROSS_SHAPES:
        for dt in (f32, bf16):
            r = flash_bwd_case(torch, timer, B, Sq, 16, 1, 64, dt, False, 0,
                               gen=gen("flash_bwd_cross", B, Sq, Sk,
                                       str(dt)), Sk=Sk)
            emit("kernel", name="flash_attention_bwd", cross=True, **r)
    return main


def synthetic_index(np, pq, C, L, D, counts, m=64, nbits=8, seed=0):
    """An IVF (or IVF-PQ) index at a given shape without the k-means build:
    ``counts[c]`` unit rows in list c (the rest padding, id -1, inv 0),
    centroids and anchors the lists' means, random codes and codebooks."""
    from repro_torch.kernels.knn_ivf.ops import assemble_ivf, assemble_ivfpq
    rng = np.random.default_rng(seed)
    n = int(np.sum(counts))
    X = rng.standard_normal((n, D), dtype=np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    sup = np.zeros((C, L, D), np.float32)
    ids = np.full((C, L), -1, np.int32)
    inv = np.zeros((C, L), np.float32)
    cent = np.zeros((C, D), np.float32)
    perm = rng.permutation(n)
    at = 0
    for c, cnt in enumerate(counts):
        rows = perm[at:at + cnt]
        at += cnt
        sup[c, :cnt], ids[c, :cnt] = X[rows], rows
        inv[c, :cnt] = 1.0 / np.linalg.norm(X[rows], axis=1)
        cent[c] = X[rows].mean(0)
    anchors = cent.copy()
    cent /= np.maximum(np.linalg.norm(cent, axis=1, keepdims=True), 1e-12)
    if not pq:
        return assemble_ivf(cent, sup, ids, inv, n, "cuda"), X
    codes = rng.integers(0, 256, (C, m * nbits // 8, L), dtype=np.uint8)
    cb = 0.05 * rng.standard_normal((m, 2 ** nbits, D // m), dtype=np.float32)
    return assemble_ivfpq(cent, anchors, codes, ids, inv, cb, X, n, m, nbits,
                          "cuda"), X


def tied_error(torch, out, ref, rtol, atol):
    """Max abs score error of a kernel's (scores, ids) against its plain
    version; fails unless scores agree within (rtol, atol), empty slots
    agree (-inf / -1), and every differing id ties within the tolerance
    with a score the plain version holds in the same row."""
    ks, ki, rs, ri = (t.cpu() for t in (*out, *ref))
    fin = torch.isfinite(rs)
    assert torch.equal(fin, torch.isfinite(ks)), "empty slots differ"
    assert torch.equal(ki < 0, ~fin), "ids of empty slots must be -1"
    err = float((ks - rs)[fin].abs().max()) if fin.any() else 0.0
    assert torch.allclose(ks[fin], rs[fin], rtol=rtol, atol=atol), err
    diff = (ki != ri) & fin
    for r, c in diff.nonzero().tolist():
        near = (rs[r] - ks[r, c]).abs() <= atol + rtol * abs(float(ks[r, c]))
        assert bool((ri[r][near] == ki[r, c]).any()), ("untied id", r, c)
    return err, int(diff.sum()), int((~fin).sum())


def unit_queries(torch, Q, D, gen):
    q = torch.randn(Q, D, device="cuda", generator=gen)
    return q / q.norm(dim=1, keepdim=True)


def ptxas_by_function(log):
    """{entry function: {registers, spill_stores, spill_loads, smem}} from
    an `nvcc -Xptxas -v` log (the build writes it beside the library)."""
    import re
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", ln)
        if m and fn:
            out[fn].update(registers=int(m.group(1)),
                           smem=int(m.group(2)))
    return out


def kernel4_tiles_ptxas():
    """Registers, spills and shared memory of kernel 4 at each query tile:
    ptxas's report of each `ivf_tile_kernel<VEC, QT>` and the dynamic
    shared memory the library asks for (`ivf_topk_dynamic_smem`)."""
    import ctypes
    import re
    from repro_torch.kernels import _build
    lib = _build.load("ivf_topk")
    lib.ivf_topk_dynamic_smem.restype = ctypes.c_int
    log = _build.library_path("ivf_topk").with_suffix(".log").read_text()
    tiles = {}
    for fn, rep in ptxas_by_function(log).items():
        m = re.search(r"ivf_tile_kernelILi(\d+)ELi(\d+)E", fn)
        if m:
            tiles[f"VEC={m.group(1)} QT={m.group(2)}"] = rep
    assert len(tiles) == 8, tiles
    return dict(dynamic_smem=lib.ivf_topk_dynamic_smem(), by_instance=tiles)


def qt_sweep(torch, timer, args, delta=None, iters=10):
    """Kernel 4 at every instantiated query tile on one case's inputs:
    each tile's scores and ids bitwise equal to QT 16's (the parent's
    kernel), the tile launched the one asked for (with none asked for,
    `block_q_for` the batch), its ms and bound, and the (tile, list)
    reads its design makes; with the sha256 of QT 16's outputs."""
    import hashlib
    import numpy as np
    from repro_torch.kernels.knn_ivf.ops import (IVF_BLOCK_QS, block_q_for,
                                                 ivf_scan)
    base = ivf_scan(*args, delta=delta, block_q=16)
    assert ivf_scan.last_block_q == 16
    h = hashlib.sha256()
    for t in base:
        h.update(t.cpu().numpy().tobytes())
    # with no tile asked for, the batch picks it
    got = ivf_scan(*args, delta=delta)
    assert ivf_scan.last_block_q == block_q_for(len(args[0])), \
        ivf_scan.last_block_q
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    C = args[2].shape[0]
    pr = args[1].cpu().numpy()
    out = {}
    for qt in IVF_BLOCK_QS:
        got = ivf_scan(*args, delta=delta, block_q=qt)
        assert ivf_scan.last_block_q == qt, (qt, ivf_scan.last_block_q)
        assert torch.equal(got[0], base[0]) and torch.equal(
            got[1], base[1]), f"QT {qt} differs from QT 16"
        reads = sum(len(np.unique(t[(t >= 0) & (t < C)]))
                    for t in (pr[i:i + qt] for i in range(0, len(pr), qt)))
        out[qt] = dict(ms=timer(lambda: ivf_scan(*args, delta=delta,
                                                 block_q=qt), iters=iters),
                       list_reads=reads, bitwise_equal_qt16=True)
    return out, h.hexdigest()


def ivf_case(torch, timer, index, Q, P, k, tol, gen, label, rows=None,
             q=None, probe=None, profile=False, tiles=False):
    """Kernel 4 against its plain version.  ``probe`` replaces the coarse
    probe (shared probe sets, a list probed twice, padded queries: rows of
    -1, which must come out empty and are left out of the plain version,
    whose indexing would wrap them); ``rows`` (nprobe = C) holds the scores
    to the exact scan's.  A second call must return the same bits (the
    tickets are reset by the selecting blocks), the kernel library's own
    count must read 1 CUDA launch for k <= 2,048 and 1 + ceil(k / 1,024)
    above; ``profile`` adds one profiled call (device time by launch)."""
    from repro_torch.kernels.knn_ivf.ops import IVF_ONE_LAUNCH_KMAX, ivf_scan
    from repro_torch.kernels.knn_ivf.ref import ivf_probe, ivf_scan_plain
    from repro_torch.kernels.knn_topk.ref import knn_topk_reference
    C, L, D = index.sup_cm.shape
    if q is None:
        q = unit_queries(torch, Q, D, gen)
    if probe is None:
        probe = ivf_probe(q, index.centroids, P)
    P = probe.shape[1]
    args = (q, probe, index.sup_cm, index.ids_cm, index.inv_cm, k)
    out = ivf_scan(*args)
    cuda_launches = ivf_scan.last_cuda_launches
    again = ivf_scan(*args)
    padded = (probe < 0).all(1)
    live = ~padded
    ref = ivf_scan_plain(q[live], probe[live], *args[2:])
    torch.cuda.synchronize()
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1]), \
        "a second call returned other bits"
    assert bool((out[1][padded] == -1).all()) and bool(
        torch.isneginf(out[0][padded]).all()), "a padded query is not empty"
    assert cuda_launches == (1 if k <= IVF_ONE_LAUNCH_KMAX
                             else 1 + math.ceil(k / 1024)), cuda_launches
    err, swaps, empty = tied_error(torch, (out[0][live], out[1][live]), ref,
                                   0.0, tol)
    if rows is not None:        # nprobe = C: the exact scan's scores
        ex = knn_topk_reference(q, torch.from_numpy(rows).cuda(), k)
        fin = torch.isfinite(ex[0])
        err = max(err, float((out[0] - ex[0])[fin].abs().max()))
        assert err <= tol, ("nprobe = C differs from the exact scan", err)
    ms = timer(lambda: ivf_scan(*args))
    plain = timer(lambda: ivf_scan_plain(*args))
    lists = int(probe[(probe >= 0) & (probe < C)].unique().numel())
    b_ms, b_by = bound(Q * D * 4 + Q * P * 4 + lists * L * (D * 4 + 8)
                       + Q * k * 8, 2 * Q * P * L * D, torch.float32)
    r = dict(case=f"{label}: Q={Q} C={C} L={L} D={D} P={P} k={k} "
                  f"probed_lists={lists}",
             max_abs_err=err, tol=tol, tied_id_swaps=swaps,
             empty_slots=empty, ms=ms, plain_ms=plain, library_ms=None,
             bound_ms=b_ms, bound_by=b_by, repeat_bitwise_equal=True,
             cuda_launches=cuda_launches)
    if tiles:
        r["block_q"], r["sha256_qt16"] = qt_sweep(torch, timer, args)
        for v in r["block_q"].values():
            v.update(bound_ms=b_ms, bound_by=b_by)
    if profile:
        p = r["launch_profile"] = device_profile(
            torch, lambda: ivf_scan(*args), top=6,
            groups={"ivf_topk": "ivf_tile_kernel"}, require="ivf_topk",
            library_count=lambda: ivf_scan.last_cuda_launches)
        assert p.get("device_launches", p.get("library_launches")) \
            == cuda_launches, (p, cuda_launches)
    return r


def adc_case(torch, timer, index, Q, P, k, gen, label, q=None,
             profile=False, fused=None):
    """Kernel 5 against its plain version: through `ivfpq_adc` (the path
    the shape picks) where ``fused`` is None, else on the path it names
    (`_adc_cuda`, the wrapper's launch on one path); ``profile`` adds one
    profiled call: device time by CUDA launch inside the call."""
    from repro_torch.kernels.knn_ivf.ops import (_adc_cuda, fused_fits,
                                                 ivfpq_adc)
    from repro_torch.kernels.knn_ivf.ref import ivf_probe, ivfpq_adc_plain
    C, MB, L = index.codes_cm.shape
    D, m, nbits = index.anchors.shape[1], index.m, index.nbits
    K = 2 ** nbits
    if q is None:
        q = unit_queries(torch, Q, D, gen)
    probe = ivf_probe(q, index.centroids, P)
    args = (q, probe, index.codes_cm, index.ids_cm, index.inv_cm,
            index.anchors, index.codebooks, k)
    if fused is None:
        call = lambda: ivfpq_adc(*args, m=m, nbits=nbits)  # noqa: E731
    else:
        call = lambda: _adc_cuda(*args, m=m, nbits=nbits,  # noqa: E731
                                 fused=fused)
    out = call()
    cuda_launches = ivfpq_adc.last_cuda_launches
    ref = ivfpq_adc_plain(*args, m, nbits)
    torch.cuda.synchronize()
    err, swaps, empty = tied_error(torch, out, ref, 1e-4, 1e-5)
    ms = timer(call)
    plain = timer(lambda: ivfpq_adc_plain(*args, m, nbits))
    lists = int(probe.unique().numel())
    b_ms, b_by = bound(Q * D * 4 + Q * P * 4 + m * K * (D // m) * 4
                       + lists * (MB * L + L * 8 + D * 4) + Q * k * 8,
                       2 * Q * K * D + Q * P * L * (m + 2) + 2 * Q * P * D,
                       torch.float32)
    if fused is None:
        fused = fused_fits(m, nbits, MB, L, P, k)
    taken = "fused" if fused else "three_launch"
    out = dict(case=f"{label}: Q={Q} C={C} L={L} D={D} P={P} kk={k} m={m} "
                    f"nbits={nbits} probed_lists={lists} path={taken}",
               max_abs_err=err, tol="rtol 1e-4, atol 1e-5",
               tied_id_swaps=swaps, empty_slots=empty, ms=ms,
               plain_ms=plain, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, cuda_launches=cuda_launches)
    assert cuda_launches == (1 if taken == "fused"
                             else 2 + math.ceil(k / 1024)), cuda_launches
    if profile:
        p = out["launch_profile"] = device_profile(
            torch, call, top=6, groups={"ivfpq_adc": "adc_"},
            require="ivfpq_adc",
            library_count=lambda: ivfpq_adc.last_cuda_launches)
        assert p.get("device_launches", p.get("library_launches")) \
            == cuda_launches, (p, cuda_launches)
    return out


def phase_ivf_kernels(torch, timer, gen):
    """Kernels 4 and 5 at the main path's shape, then the edge cases:
    nbits 4, Q = 1, 17 (a partial query tile) and 64, 16 queries sharing
    one probe set, nprobe = C on a small index, probed lists holding fewer
    than k rows (the tail must be -inf / -1), k = 1, 2,048 (kernel 4's last
    one-launch k) and 2,049 (the scan and three selection rounds) of the
    main shape's 8 x 400 candidates, and D = 30 with a list probed twice
    and a padded query.
    ``gen(*key)`` gives each case its generator.  Returns the main cases."""
    import numpy as np
    from repro_torch.kernels.knn_ivf.ref import ivf_probe
    g = IVF_MAIN
    counts = np.full(g["C"], g["N"] // g["C"])
    counts[:g["N"] % g["C"]] += 1
    main = {}
    ivf, _ = synthetic_index(np, False, g["C"], g["L"], g["D"], counts)
    emit("kernel4_tiles_ptxas", **kernel4_tiles_ptxas())
    for i, (Q, label) in enumerate([(16, "main"), (1, "Q=1"), (64, "Q=64"),
                                    (17, "Q=17")]):
        r = ivf_case(torch, timer, ivf, Q, g["P"], g["k"], 1e-5,
                     gen("ivf", label), label, profile=i == 0, tiles=True)
        emit("kernel", name="ivf_topk", **r)
        if i == 0:
            main["ivf_topk"] = r
    # 16 queries on one probe set: every list's owner serves all 16, and
    # the block that completes them selects them in groups
    q = unit_queries(torch, 16, g["D"], gen("ivf", "shared"))
    shared = ivf_probe(q[:1], ivf.centroids, g["P"]).expand(16, -1)
    emit("kernel", name="ivf_topk", **ivf_case(
        torch, timer, ivf, 16, g["P"], g["k"], 1e-5, None, "shared probes",
        q=q, probe=shared.contiguous(), tiles=True))
    small_counts = np.full(24, 40)
    small, rows = synthetic_index(np, False, 24, 48, 128, small_counts,
                                  seed=1)
    emit("kernel", name="ivf_topk", **ivf_case(
        torch, timer, small, 16, 24, 100, 1e-5, gen("ivf", "nprobe=C"),
        "nprobe=C", rows=rows))
    # 3-6 valid rows in lists of 64: more candidates (128) than k but
    # fewer valid ones, so the selection's k-th key is an empty slot's
    short, _ = synthetic_index(np, False, 32, 64, 128,
                               np.arange(32) % 4 + 3, seed=2)
    r = ivf_case(torch, timer, short, 16, 2, 100, 1e-5,
                 gen("ivf", "short lists"), "short lists")
    assert r["empty_slots"] > 0
    emit("kernel", name="ivf_topk", **r)
    for k in (2048, 2049, 1):
        emit("kernel", name="ivf_topk", **ivf_case(
            torch, timer, ivf, 16, g["P"], k, 1e-5, gen("ivf", f"k={k}"),
            f"k={k}", tiles=k == 2049))
    del ivf
    # D = 30 (4-byte copies), a list probed twice by one query (its rows
    # twice in the result) and a padded query (a probe row of -1)
    odd, _ = synthetic_index(np, False, 20, 72, 30, np.full(20, 60), seed=4)
    q = unit_queries(torch, 20, 30, gen("ivf", "odd"))
    pr = ivf_probe(q, odd.centroids, 5)
    pr[5, 2] = pr[5, 0]
    pr[3] = -1
    emit("kernel", name="ivf_topk", **ivf_case(
        torch, timer, odd, 20, 5, 50, 1e-5, None, "D=30, a list probed twice,"
        " a padded query", q=q, probe=pr))

    # kernel 5 on both paths: the fused one-launch path is the shape's
    # choice at these shapes, and each also runs on the three launches
    # (`_adc_cuda`); then the three launches as the shape's choice: nprobe
    # = C on the 265 lists of 400 and kk > 2,048, at nbits 8 and 4, Q 1,
    # 16 and 64
    pq8, _ = synthetic_index(np, True, g["C"], g["L"], g["D"], counts,
                             m=g["m"], nbits=8)
    pq4, _ = synthetic_index(np, True, g["C"], g["L"], g["D"], counts,
                             m=g["m"], nbits=4, seed=3)
    small, _ = synthetic_index(np, True, 24, 48, 128, small_counts, m=16,
                               seed=1)
    short, _ = synthetic_index(np, True, 32, 64, 128, np.arange(32) % 4 + 3,
                               m=16, seed=2)
    for i, (idx, nb, Q, P, kk, label) in enumerate([
            (pq8, 8, 16, g["P"], g["kk"], "main"),
            (pq8, 8, 1, g["P"], g["kk"], "Q=1"),
            (pq8, 8, 64, g["P"], g["kk"], "Q=64"),
            (pq4, 4, 16, g["P"], g["kk"], "nbits=4"),
            (pq4, 4, 1, g["P"], g["kk"], "nbits=4 Q=1"),
            (pq4, 4, 64, g["P"], g["kk"], "nbits=4 Q=64"),
            (small, 8, 16, 24, 100, "nprobe=C"),
            (short, 8, 16, 2, 100, "short lists"),
            (pq8, 8, 16, g["P"], 2048, "k=2048"),
            (pq4, 4, 16, g["P"], 2048, "nbits=4 k=2048")]):
        for fused in (None, False):
            r = adc_case(torch, timer, idx, Q, P, kk,
                         gen("ivfpq", label, nb), label, fused=fused,
                         profile=(i in (0, 8)))
            assert ("path=fused" in r["case"]) == (fused is None), r["case"]
            if label == "short lists":
                assert r["empty_slots"] > 0
            emit("kernel", name="ivfpq_adc", **r)
            if i == 0 and fused is None:
                main["ivfpq_adc"] = r
    for idx, nb, Q, P, kk, label in [
            (pq8, 8, 16, g["C"], g["kk"], "nprobe=C"),
            (pq8, 8, 16, g["P"], 3000, "k=3000"),
            (pq8, 8, 1, g["C"], g["kk"], "nprobe=C Q=1"),
            (pq8, 8, 64, g["P"], 3000, "k=3000 Q=64"),
            (pq4, 4, 64, g["C"], g["kk"], "nbits=4 nprobe=C Q=64"),
            (pq4, 4, 1, g["P"], 3000, "nbits=4 k=3000 Q=1")]:
        r = adc_case(torch, timer, idx, Q, P, kk, gen("ivfpq", label, nb),
                     label, profile=Q == 16)
        assert "path=three_launch" in r["case"], r["case"]
        emit("kernel", name="ivfpq_adc", **r)
    del pq4
    return main


def delta_tier(np, ivf_ops, base, tier, probed, hot, seed):
    """A `DynamicIVFIndex` over ``base`` with a delta tier of one kind:
    ``few`` (two rows in each list), ``per_list`` (64 rows in each list:
    about 64 a probed list), ``skewed`` (4,096 rows in list ``hot``, which
    every query count probes) or ``empty`` (rows only in lists no query
    probes).  Rows lie near their list's centroid, so they are assigned to
    it."""
    rng = np.random.default_rng(seed)
    cent = base.centroids_h
    C, D = cent.shape

    def near(c, n):
        return (cent[c] + 0.01 * rng.standard_normal(
            (n, D), dtype=np.float32)).astype(np.float32)
    if tier == "few":
        rows = np.concatenate([near(c, 2) for c in range(C)])
    elif tier == "per_list":
        rows = np.concatenate([near(c, 64) for c in range(C)])
    elif tier == "skewed":
        rows = near(hot, 4096)
    else:
        free = [c for c in range(C) if c not in probed]
        rows = np.concatenate([near(c, 8) for c in free[:8]])
        # keep the rows assigned to an unprobed list (split lists can have
        # near-equal centroids)
        rn = rows / np.linalg.norm(rows, axis=1, keepdims=True)
        rows = rows[~np.isin(np.argmax(rn @ cent.T, axis=1),
                             sorted(probed))]
        assert len(rows), "no row landed in an unprobed list"
    dyn = ivf_ops.DynamicIVFIndex(base)
    dyn.append(rows)
    return dyn


def phase_delta_kernels(torch, timer, gen):
    """Kernels 4 and 5 with a streaming index's delta sub-lists in the same
    launch, on the main shape's synthetic indexes (265 lists of 400, D 768,
    nprobe 8, k 100, kk 800, m 64) with tiers `delta_tier` builds, at Q 1,
    16 and 64: against the plain versions on the card (tie rule
    `tied_error`), a second call bitwise equal, ms, plain ms and the bound
    (the distinct probed lists' and sub-lists' bytes), and the kernel
    library's launches: 1 for kernel 4 (k <= 2,048) and on kernel 5's fused
    path, which runs where `fused_fits` (the skewed tier does not fit: the
    three launches) and also on the three launches."""
    import numpy as np
    from repro_torch.kernels.knn_ivf import ops as ivf_ops
    from repro_torch.kernels.knn_ivf.ref import (ivf_probe, ivf_scan_plain,
                                                 ivfpq_adc_plain)
    g = IVF_MAIN
    counts = np.full(g["C"], g["N"] // g["C"])
    counts[:g["N"] % g["C"]] += 1
    ivf, _ = synthetic_index(np, False, g["C"], g["L"], g["D"], counts)
    pq8, _ = synthetic_index(np, True, g["C"], g["L"], g["D"], counts,
                             m=g["m"], nbits=8)
    q64 = unit_queries(torch, 64, g["D"], gen("delta", "queries"))
    probe64 = ivf_probe(q64, ivf.centroids, g["P"])
    probed = set(probe64.unique().tolist())
    t0 = time.perf_counter()
    for tier in ("few", "per_list", "skewed", "empty"):
        dyns = {name: delta_tier(np, ivf_ops, base, tier, probed,
                                 int(probe64[0, 0]), 7)
                for name, base in (("ivf_topk", ivf), ("ivfpq_adc", pq8))}
        for Q in (1, 16, 64):
            q, probe = q64[:Q].contiguous(), probe64[:Q].contiguous()
            for name, dyn in dyns.items():
                snap = dyn.fused_state()
                b, d = snap.base, snap.delta
                lens = (d.off[1:] - d.off[:-1]).long()
                sub_rows = int(lens[probe.long().unique()].sum())
                if tier == "empty":
                    assert sub_rows == 0, sub_rows
                lists = int(probe.unique().numel())
                if name == "ivf_topk":
                    k = g["k"]
                    args = (q, probe, b.sup_cm, b.ids_cm, b.inv_cm, k)
                    runs = {"one_launch": lambda: ivf_ops.ivf_scan(  # noqa: E731
                        *args, delta=d)}
                    plain = lambda: ivf_scan_plain(*args, d)  # noqa: E731
                    nbytes = lists * g["L"] * (g["D"] * 4 + 8) \
                        + sub_rows * (g["D"] * 4 + 8)
                    flops = 2 * Q * g["P"] * g["L"] * g["D"] \
                        + 2 * Q * sub_rows * g["D"]
                    wrapper = ivf_ops.ivf_scan
                else:
                    k = g["kk"]
                    MB = b.codes_cm.shape[1]
                    args = (q, probe, b.codes_cm, b.ids_cm, b.inv_cm,
                            b.anchors, b.codebooks, k)
                    fits = ivf_ops.fused_fits(b.m, b.nbits, MB, g["L"],
                                              g["P"], k, d.lmax)
                    assert fits == (tier != "skewed"), (tier, d.lmax)
                    runs = {"three_launch": lambda: ivf_ops._adc_cuda(  # noqa: E731
                        *args, m=b.m, nbits=b.nbits, fused=False, delta=d)}
                    if fits:
                        runs["fused"] = lambda: ivf_ops._adc_cuda(  # noqa: E731
                            *args, m=b.m, nbits=b.nbits, fused=True, delta=d)
                    plain = lambda: ivfpq_adc_plain(  # noqa: E731
                        *args, b.m, b.nbits, d)
                    nbytes = lists * (MB * g["L"] + g["L"] * 8 + g["D"] * 4) \
                        + sub_rows * (MB + 8) + b.codebooks.numel() * 4
                    flops = 2 * Q * 256 * g["D"] \
                        + Q * (g["P"] * g["L"] + sub_rows) * (b.m + 2)
                    wrapper = ivf_ops.ivfpq_adc
                nbytes += Q * g["D"] * 4 + Q * g["P"] * 4 + Q * k * 8 \
                    + (g["C"] + 1) * 4
                b_ms, b_by = bound(nbytes, flops, torch.float32)
                ref = plain()
                p_ms = timer(plain, iters=3, warmup=1)
                for path, call in runs.items():
                    out = call()
                    launches = wrapper.last_cuda_launches
                    again = call()
                    torch.cuda.synchronize()
                    assert torch.equal(out[0], again[0]) and torch.equal(
                        out[1], again[1]), ("a second call differs", tier,
                                            name, Q, path)
                    rtol = 1e-4 if name == "ivfpq_adc" else 0.0
                    err, swaps, empty = tied_error(torch, out, ref, rtol,
                                                   1e-5)
                    want = (1 if path in ("one_launch", "fused")
                            else 2 + math.ceil(k / 1024))
                    assert launches == want, (tier, name, Q, path, launches)
                    emit("kernel_delta", name=name, tier=tier, Q=Q,
                         path=path, k=k, delta_rows=int(d.rows.shape[0]),
                         lmax=int(d.lmax), probed_lists=lists,
                         probed_sub_list_rows=sub_rows,
                         max_abs_err=err, tol=(
                             "rtol 1e-4, atol 1e-5" if rtol else 1e-5),
                         tied_id_swaps=swaps, empty_slots=empty,
                         delta_ids_in_result=int(
                             (out[1] >= d.n_base).sum()),
                         repeat_bitwise_equal=True, cuda_launches=launches,
                         ms=timer(call, iters=5, warmup=1), plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by)
                if name == "ivf_topk":
                    sweep, sha = qt_sweep(torch, timer, args, delta=d,
                                          iters=5)
                    emit("kernel_delta_tiles", name=name, tier=tier, Q=Q,
                         k=k, block_q=sweep, sha256_qt16=sha,
                         bound_ms=b_ms, bound_by=b_by)
        del dyns
    emit("kernel_delta_done", wall_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def kernel_wrappers():
    """Every kernel's wrapper, by the name in the kernels line."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    from repro_torch.kernels.knn_ivf.ops import ivf_scan, ivfpq_adc
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.ssd_scan.ops import ssd_intra, ssd_intra_bwd
    return {"knn_topk": knn_topk, "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention, "ivf_topk": ivf_scan,
            "ivfpq_adc": ivfpq_adc, "ssd_intra": ssd_intra,
            "ssd_intra_bwd": ssd_intra_bwd}


def stage_timer(torch, stages):
    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out
    return stage


def phase_main_path(torch):
    """Slice 1's path: `knn10` (exact retrieval) serving 16 texts.  Returns
    the launch counts of this path and the context the next path reuses
    (engines, encoder, support set, texts, lambdas)."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.routers import make_router
    from repro_torch.core.routers.knn import _serve_tail
    from repro_torch.launch.serve import TOPICS, build_support
    from repro_torch.models import model as M
    from repro_torch.serving.encoder import QueryEncoder
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.router_service import RouterService

    wrappers = kernel_wrappers()
    pool = ["qwen3-4b", "h2o-danube-1.8b"]
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    stage = stage_timer(torch, stages)
    for w in wrappers.values():
        w.launches = 0

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
    missing = [n for n in ("knn_topk", "flash_attention", "decode_attention")
               if launches[n] == 0]
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
    S_cpu, C_cpu = plain._support_dev()
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
    # the route of the 16 texts is one CUDA launch of kernel 1
    route_prof = device_profile(
        torch, lambda: svc.router.serve_fused(emb, lams), top=8,
        groups={"knn_topk": "knn_"}, require="knn_topk")
    svc.router.serve_fused(emb, lams)
    from repro_torch.kernels.knn_topk.ops import knn_topk
    emit("route_profile", route="knn10", texts=16, window=route_prof,
         cuda_launches_of_knn_topk=knn_topk.last_cuda_launches)
    assert knn_topk.last_cuda_launches == 1
    assert route_prof["knn_topk"]["count"] == 1, route_prof
    emit("main_path_checks", embed_16_texts_s=t1 - t0,
         route_16_texts_s=t2 - t1, route_max_abs_err=route_err, route_tol=1e-5,
         route_choices_equal=int((out[0] == tail[0]).sum()),
         rows_with_tied_neighbour_swaps=int((~same).sum()),
         reduced_greedy_tokens_equal=True)
    # where a serve's device time goes: one profiled window of 4 of the
    # texts (one at each lambda) with 4 new tokens each, after a warm one
    prof = device_profile(
        torch, lambda: svc.serve_texts(texts[:4], lam=lams[:4],
                                       max_new_tokens=4),
        top=12, groups={"decode_attention": "decode_",
                        "flash_attention": "flash_fwd",
                        "knn_topk": "knn_"})
    emit("serve_profile", texts=4, max_new_tokens=4, window=prof)
    ctx = dict(engines=engines, encoder=encoder, ds=ds, texts=texts,
               lams=lams, knn10_svc=svc)
    return launches, ctx


def recall_at_k(np, router, emb, X, exact_s, tol=1e-5):
    """Recall@k of ``router``'s neighbours against the exact k nearest
    (scores ``exact_s`` (Q, k)), counted by score: the support holds
    near-duplicate texts, so a returned row counts when its exact score is
    at least the exact k-th score minus ``tol``."""
    _, idx = router._neighbors(emb)
    qn = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    true = np.einsum("qkd,qd->qk", X[np.maximum(idx, 0)], qn)
    hits = (true >= exact_s[:, -1:] - tol) & (idx >= 0)
    return float(hits.sum() / exact_s.size)


def route_walls(torch, fn, reps=7):
    """Host-clock seconds of ``reps`` calls of ``fn`` after a warm one,
    each ending in a device sync: median, min and max."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    walls.sort()
    return dict(median_s=walls[reps // 2], min_s=walls[0], max_s=walls[-1])


def device_profile(torch, fn, top=8, groups=None, require=None, windows=3,
                   library_count=None):
    """One call of ``fn`` (after a warm one) under `torch.profiler`: the
    device time of each kernel by name, their sum and count, the call's
    host wall with the profiler on, and the device's idle share of that one
    window (1 - kernel time / wall); ``groups`` (label -> substring of
    kernel names) adds each group's device ms and launches.  The profiler
    traces a warm-up call first and discards it (its `schedule`): windows
    that opened on the call itself lost their first kernels on an H100,
    the more so later in a run.  Where a window still records none of a
    kernel library's launches, with
    ``require`` (a label of ``groups``) the window is taken again, up to
    ``windows`` times, until that group's kernels are recorded; the run
    fails if they never are.  ``windows_taken`` says how many it took and
    ``missed`` what the windows that missed recorded.  With
    ``library_count`` (the kernel library's own count of the CUDA launches
    of ``fn``'s last call) a group no window recorded reads "not measured"
    with that count beside it, which must be above 0; the phase-3 cases
    pass it, since one earlier run lost three IVF-PQ windows of one
    kernel each.  Without ``require``, a fault of the profiler itself reads "not
    measured"; a fault of ``fn`` fails the run."""
    missed = []
    for w in range(1, windows + 1):
        out = _profile_window(torch, fn, top, groups or {})
        if require is None:
            out.pop("all_kernels", None)
            return out
        if out.get(require, {}).get("count"):
            out.update(windows_taken=w, missed=missed)
            del out["all_kernels"]
            return out
        missed.append(out.get("not_measured") or out["all_kernels"])
    if library_count is not None:
        n = library_count()
        assert n > 0, f"{require}: the kernel library counted {n} launches"
        return dict(not_measured=f"the profiler recorded no {require} "
                    f"kernel in {windows} windows", library_launches=n,
                    windows_taken=windows, missed=missed)
    raise AssertionError(f"the profiler recorded no {require} kernel in "
                         f"{windows} windows: {missed}")


def _profile_window(torch, fn, top, groups):
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    traced = []
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1),
                       on_trace_ready=lambda p: traced.append(
                           p.key_averages()))
        prof.start()
    except Exception as exc:      # the profiler could not start
        return {"not_measured": f"{type(exc).__name__}: {exc}"}
    try:
        # the warm-up step traces one call and discards it; the active
        # step's call is the window
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    finally:
        prof.stop()
    try:
        rows = []
        for e in (traced[0] if traced else []):
            # the step's own range carries its kernels' device time too
            if not str(e.device_type).endswith("CUDA") \
                    or e.key.startswith("ProfilerStep"):
                continue
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            rows.append((t, e.key, e.count))
    except Exception as exc:      # the profiler recorded nothing readable
        return {"not_measured": f"{type(exc).__name__}: {exc}"}
    if not rows:
        return {"not_measured": "the profiler saw no device kernel"}
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    out = dict(wall_with_profiler_s=wall, device_kernel_s=busy,
               device_idle_share=1.0 - busy / wall,
               device_launches=sum(r[2] for r in rows),
               kernels=[dict(name=k[:70], ms=t / 1e3, count=c)
                        for t, k, c in rows[:top]])
    for label, sub in groups.items():
        hit = [r for r in rows if sub in r[1]]
        out[label] = dict(ms=sum(r[0] for r in hit) / 1e3,
                          count=sum(r[2] for r in hit))
    out["all_kernels"] = [k[:40] for _, k, _ in rows]
    return out


def probe_witness(torch, np, router, qn, X, exact_s, tol=1e-5):
    """What the coarse probe leaves reachable on the real index, from the
    host: per query, the exact neighbours (rows of ``X`` scoring at least
    the exact k-th score ``exact_s[:, -1]`` minus ``tol``, as `recall_at_k`
    counts them) that lie in the query's
    probed lists, capped at k.  An IVF scan that is exact over its probed
    rows has exactly this many hits.  Also the number of distinct lists
    that hold a query's exact top k, and the queries whose probe set
    differs from a float64 host probe other than by centroids tied within
    1e-6."""
    idx, k = router._ivf, router.k
    cent = idx.centroids_h.astype(np.float64)
    owner = np.empty(idx.n_rows, np.int64)
    valid = idx.ids_h >= 0
    owner[idx.ids_h[valid]] = np.nonzero(valid)[0]
    from repro_torch.kernels.knn_ivf.ref import ivf_probe
    probe = ivf_probe(torch.from_numpy(qn).to(idx.device), idx.centroids,
                      router.nprobe).cpu().numpy()
    cs = qn.astype(np.float64) @ cent.T
    host = np.argsort(-cs, axis=1, kind="stable")[:, :router.nprobe]
    untied = 0
    for r in range(len(qn)):
        diff = set(probe[r]) ^ set(host[r])
        edge = cs[r, host[r, -1]]
        untied += any(abs(cs[r, c] - edge) > 1e-6 for c in diff)
    sims = X @ qn.T                                             # (N, Q)
    reach, spread = [], []
    for r in range(len(qn)):
        order = np.argsort(-sims[:, r], kind="stable")
        good = np.flatnonzero(sims[:, r] >= exact_s[r, -1] - tol)
        reach.append(min(k, int(np.isin(owner[good], probe[r]).sum())))
        spread.append(len(set(owner[order[:k]])))
    return dict(reachable_hits=int(sum(reach)), of=len(qn) * k,
                lists_holding_exact_top_k=dict(
                    min=int(min(spread)), median=float(np.median(spread)),
                    max=int(max(spread))),
                probe_rows_differing_untied=int(untied))


def phase_ivf_path(torch, ctx):
    """Slice 2's path on the same engines, encoder and 100k support:
    `knn100-ivfpq` fitted through `RoutingPipeline`, saved, a service
    re-booted from the artifact serving the 16 texts, and `knn100-ivf`
    routing the same embeddings with `route_fused`.  Counters are zeroed
    just before and read just after.  Then: recall@100 of both against the
    exact kernel at nprobe 8, 32 and C (the IVF scan must read 1.0 at C,
    and at 8 exactly what its probe leaves reachable), choice agreement
    with the exact router, the artifact service's choices against the
    in-memory one's, and both kernels against their plain versions on the
    real index and the 16 embedded texts, timed and bounded there.
    Returns the launch counts and those two kernel cases."""
    import numpy as np
    from repro_torch.core.routers import make_router
    from repro_torch.serving.pipeline import RoutingPipeline
    from repro_torch.serving.router_service import RouterService

    engines, encoder, ds = ctx["engines"], ctx["encoder"], ctx["ds"]
    texts, lams = ctx["texts"], ctx["lams"]
    wrappers = kernel_wrappers()
    stages = {}
    stage = stage_timer(torch, stages)
    pipe = stage("ivfpq_index_build_s", lambda: RoutingPipeline(
        "knn100-ivfpq", device="cuda").fit(ds))
    ivf_router = stage("ivf_index_build_s", lambda: make_router(
        "knn100-ivf", device="cuda").fit(ds))
    path = stage("ivfpq_save_s", lambda: pipe.save(
        ROOT / "build" / "chip_smoke" / "knn100-ivfpq"))
    # the engine deadline runs each engine wave on a worker thread, as a
    # served deployment does (phase 6 serves this service over HTTP)
    svc = stage("ivfpq_load_s", lambda: RouterService.from_artifact(
        path, engines, device="cuda", encoder=encoder,
        engine_timeout_s=ENGINE_TIMEOUT_S))
    ivf_svc = RouterService(ivf_router, engines, encoder=encoder)
    ctx.update(ivfpq_svc=svc, ivf_svc=ivf_svc, ivfpq_path=path)

    for w in wrappers.values():
        w.launches = 0
    results = stage("ivfpq_serve_texts_s", lambda: svc.serve_texts(
        texts, lam=lams, max_new_tokens=8))
    emb = stage("embed_16_texts_s", lambda: encoder.embed_texts(texts))
    ivf_out = stage("ivf_route_16_texts_s",
                    lambda: ivf_svc.route_fused(emb, lams))
    launches = {n: w.launches for n, w in wrappers.items()}
    pq_out = svc.route_fused(emb, lams)

    mix = {}
    for r in results:
        mix[r.model] = mix.get(r.model, 0) + 1
    assert all(r.request.done and r.request.error is None for r in results)
    rerouted = [r.uid for r in results if r.rerouted_from]
    assert not rerouted, f"requests rerouted: {rerouted}"
    assert all(len(r.request.output_tokens) == 8 for r in results)
    missing = [n for n in ("ivf_topk", "ivfpq_adc", "flash_attention",
                           "decode_attention") if launches[n] == 0]
    assert not missing, f"kernels not launched on the IVF path: {missing}"
    for out in (ivf_out, pq_out):
        assert out[1].shape == (16, 2) and np.isfinite(out[1]).all()
    served = [r.model for r in results]
    assert [svc.model_names[c] for c in pq_out[0]] == served
    mem = pipe.serve(engines, encoder=encoder).route_fused(emb, lams)
    assert [svc.model_names[c] for c in mem[0]] == served, \
        "the artifact-booted service chose differently from the in-memory one"

    exact = make_router("knn100", device="cuda").fit(ds)
    e_s, _ = exact._neighbors(emb)
    exact_choice = RouterService(exact, engines, encoder=encoder
                                 ).route_fused(emb, lams)[0]
    agree = {"knn100-ivfpq": int((pq_out[0] == exact_choice).sum()),
             "knn100-ivf": int((ivf_out[0] == exact_choice).sum())}
    # recall at the default nprobe, at 4x it and at every list; what the
    # probe leaves reachable at the default, from the host
    qn = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    recall, witness = {}, {}
    for name, r in (("knn100-ivfpq", svc.router), ("knn100-ivf", ivf_router)):
        witness[name] = probe_witness(torch, np, r, qn, exact._X, e_s)
        default = r.nprobe
        for nprobe in (default, 32, r._ivf.n_clusters):
            r.nprobe = nprobe
            recall[f"{name}@nprobe={nprobe}"] = recall_at_k(
                np, r, emb, exact._X, e_s)
        r.nprobe = default
    ivf_all = recall[f"knn100-ivf@nprobe={ivf_router._ivf.n_clusters}"]
    assert ivf_all == 1.0, f"IVF recall at nprobe = C is {ivf_all}"
    w = witness["knn100-ivf"]
    ivf_hits = round(recall[f"knn100-ivf@nprobe={ivf_router.nprobe}"]
                     * w["of"])
    assert ivf_hits == w["reachable_hits"], \
        f"IVF hits {ivf_hits} != reachable {w['reachable_hits']}"
    assert all(v["probe_rows_differing_untied"] == 0
               for v in witness.values()), witness
    routes = {"knn100 (exact)": lambda: exact.serve_fused(emb, lams),
              "knn100-ivf": lambda: ivf_router.serve_fused(emb, lams),
              "knn100-ivfpq": lambda: svc.router.serve_fused(emb, lams)}
    route_s = {n: route_walls(torch, fn) for n, fn in routes.items()}
    groups = {"knn_topk": "knn_", "ivf_topk": "ivf_tile_kernel",
              "ivfpq_adc_fused": "adc_fused", "ivfpq_adc_three": "adc_scan"}
    need = {"knn100 (exact)": "knn_topk", "knn100-ivf": "ivf_topk",
            "knn100-ivfpq": "ivfpq_adc_fused"}
    profiles = {n: device_profile(torch, fn, groups=groups, require=need[n])
                for n, fn in routes.items()}
    # one CUDA launch of the redesigned kernels a route: the profile's
    # count and the kernel libraries' own
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_ivf import ops as ivf_ops
    from repro_torch.kernels.knn_ivf.ref import ivf_probe
    route_launches = {}
    for n, w in (("knn100 (exact)", knn_topk),
                 ("knn100-ivf", ivf_ops.ivf_scan),
                 ("knn100-ivfpq", ivf_ops.ivfpq_adc)):
        assert profiles[n][need[n]]["count"] == 1, (n, profiles[n])
        calls = w.launches
        routes[n]()
        assert w.launches == calls + 1, n
        route_launches[n] = w.last_cuda_launches
        assert w.last_cuda_launches == 1, (n, w.last_cuda_launches)
    assert profiles["knn100-ivfpq"]["ivfpq_adc_three"]["count"] == 0, \
        profiles["knn100-ivfpq"]
    # the route's own shortlist (its queries, probe and kk) through the
    # parent design's three launches gives the same bits, so the route
    # chooses and recalls alike on either path
    r = svc.router
    idx = r._ivf
    nprobe = max(1, min(r.nprobe, idx.n_clusters))
    cand = nprobe * idx.list_size
    k = min(r.k, idx.n_rows, cand)
    kk = min(max(r.rerank, 1) * k, idx.n_rows, cand) if r.rerank else k
    rq = r._queries(emb)
    args = (rq, ivf_probe(rq, idx.centroids, nprobe), idx.codes_cm,
            idx.ids_cm, idx.inv_cm, idx.anchors, idx.codebooks, kk)
    assert ivf_ops.fused_fits(idx.m, idx.nbits, idx.codes_cm.shape[1],
                              idx.list_size, nprobe, kk)
    fused_sl = ivf_ops.ivfpq_adc(*args, m=idx.m, nbits=idx.nbits)
    three_sl = ivf_ops._adc_cuda(*args, m=idx.m, nbits=idx.nbits,
                                 fused=False)
    assert torch.equal(fused_sl[0], three_sl[0]) \
        and torch.equal(fused_sl[1], three_sl[1]), \
        "the route's shortlist differs between the fused and three launches"

    # both kernels against their plain versions on the real index and the
    # 16 embedded texts, timed and bounded there; exact top-k above k = 128
    # on the embedded support (near-duplicate texts: cosines that crowd a
    # few exponents), with the queries whose candidates overflowed counted
    timer = Timer(torch)
    q = torch.from_numpy(qn).cuda()
    X = torch.from_numpy(exact._X).cuda()
    for k in (200, 1024):
        emit("kernel", name="knn_topk", **knn_case(
            torch, timer, 16, X.shape[0], X.shape[1], k, torch.float32, 1e-5,
            None, kind="phase-4 support", q=q, s=X))
    del X
    real = {"ivf_topk": ivf_case(
        torch, timer, ivf_router._ivf, 16, ivf_router.nprobe, 100, 1e-5,
        None, "phase-4 index", q=q, tiles=True),
            "ivfpq_adc": adc_case(
        torch, timer, idx, 16, svc.router.nprobe, 800, None,
        "phase-4 index", q=q)}
    for n, r in real.items():
        emit("kernel", name=n, **r)
    emit("ivf_path", routing_mix=mix, stage_wall_s=stages,
         launches=launches, max_memory_allocated=torch.cuda.max_memory_allocated(),
         index={"ivf": dict(C=ivf_router._ivf.n_clusters,
                            L=ivf_router._ivf.list_size),
                "ivfpq": dict(C=idx.n_clusters, L=idx.list_size, m=idx.m,
                              nbits=idx.nbits)},
         recall_at_100_vs_exact=recall, recall_tol=1e-5,
         probe_witness_at_default_nprobe=witness,
         choices_equal_to_exact_of_16=agree,
         ivfpq_route_shortlist_kk=kk,
         ivfpq_route_shortlist_bitwise_equal_three_launch=True,
         route_cuda_launches=route_launches,
         serve_fused_16_texts_s=route_s, serve_fused_profile=profiles,
         artifact_choices_equal_in_memory=True,
         tokens=[r.request.output_tokens for r in results])
    return launches, real


# ---------------------------------------------------------------------------
# phase 5: mamba2-370m trains and serves (slice 3)
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "mamba2-370m", "--steps", "10", "--batch", "4",
              "--seq", "2048", "--log-every", "1"]


def phase_train(torch):
    """5a: `repro_torch.launch.train.main` at mamba2-370m's published
    widths in bf16 (seeded weights, the zipf stream, batch 4 x 2,048
    tokens, 10 steps, per-layer remat), with the SSD kernels' counters
    zeroed just before and read just after.  Then one more step of the same
    configuration under `torch.profiler` for the device time by kernel and
    the idle share of that step."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step

    wrappers = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    hist = train.main(TRAIN_ARGS)
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    walls = [h["wall_s"] for h in hist]
    tokens = 4 * 2048
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    emit("train", arch="mamba2-370m", dtype="bfloat16", batch=4, seq=2048,
         loss=losses, grad_norm=[h["grad_norm"] for h in hist],
         step_wall_s=walls, median_step_wall_s_after_first=steady,
         tokens_per_s=tokens / steady, run_wall_s=wall,
         max_memory_allocated=peak,
         launches={n: launches[n] for n in ("ssd_intra", "ssd_intra_bwd")},
         other_launches={n: v for n, v in launches.items()
                         if n not in ("ssd_intra", "ssd_intra_bwd")})
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    assert launches["ssd_intra"] >= 480 and launches["ssd_intra_bwd"] == 480, \
        launches
    torch.cuda.empty_cache()

    cfg = get_config("mamba2-370m")
    lm = M.init_params(cfg, seed=0, device="cuda")
    opt_state = O.init(dict(lm.named_parameters()))
    step_fn = make_train_step(cfg, O.OptConfig(lr=1e-3, warmup_steps=1,
                                               total_steps=10))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2049))).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    prof = device_profile(torch, lambda: step_fn(lm, opt_state, batch),
                          top=10)
    emit("train_profile", one_step=prof)
    del lm, opt_state
    torch.cuda.empty_cache()
    return launches


def phase_forward_decode(torch):
    """5b: mamba2-370m at its published widths in f32, batch 2, S = 384
    (a full chunk of 256 and one padded to 256): `forward`'s logits against
    384 `decode_step`s of the O(1) recurrence, rtol / atol 2e-3 (the
    reference's test_models decode check).  This holds kernel 6 against an
    independent computation through 48 layers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("mamba2-370m").replace(dtype="float32")
    lm = M.init_params(cfg, seed=7, device="cuda")
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 384))).cuda()
    t0 = time.perf_counter()
    with torch.no_grad():
        full = M.forward(lm, cfg, {"tokens": toks})[0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    caches = M.init_caches(cfg, 2, 384, device="cuda")
    err, scale, argmax_equal = 0.0, 0.0, 0
    worst = 0.0
    for t in range(384):
        logits, caches = M.decode_step(lm, cfg, caches, toks[:, t:t + 1],
                                       torch.full((2,), t, device="cuda"))
        ref = full[:, t]
        d = (logits - ref).abs()
        err = max(err, float(d.max()))
        worst = max(worst, float((d - 2e-3 * ref.abs()).max()))
        scale = max(scale, float(ref.abs().max()))
        argmax_equal += int((logits.argmax(-1) == ref.argmax(-1)).sum())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    emit("forward_vs_decode", arch="mamba2-370m", dtype="float32", batch=2,
         seq=384, max_abs_err=err, max_abs_logit=scale,
         tol="rtol 2e-3, atol 2e-3", argmax_equal=argmax_equal, of=2 * 384,
         forward_s=t1 - t0, decode_384_steps_s=t2 - t1)
    assert worst <= 2e-3, ("forward and decode differ", err, worst)
    del lm, caches, full
    torch.cuda.empty_cache()


def phase_mamba_serving(torch, ctx):
    """5c: a full-width bf16 mamba2-370m engine (4 slots, 512 positions)
    joins phase 4's engines as the reference's three-model pool; `knn10`
    fitted on a 100,000-row support for the three serves the 16 texts.
    Then the Mamba engine alone: 16 prompts with staggered lengths, admitted
    as slots free while others are mid-stream, must each decode the tokens
    they decode served alone."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.routers import make_router
    from repro_torch.launch.serve import build_support
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.router_service import RouterService

    pool = ["qwen3-4b", "mamba2-370m", "h2o-danube-1.8b"]
    wrappers = kernel_wrappers()
    stages = {}
    stage = stage_timer(torch, stages)
    mamba = stage("mamba_engine_init_s", lambda: ServingEngine(
        get_config("mamba2-370m"), max_slots=4, cache_len=512, seed=2,
        device="cuda"))
    engines = {"qwen3-4b": ctx["engines"]["qwen3-4b"], "mamba2-370m": mamba,
               "h2o-danube-1.8b": ctx["engines"]["h2o-danube-1.8b"]}
    encoder, texts, lams = ctx["encoder"], ctx["texts"], ctx["lams"]
    ds = stage("support_embed_100k_s", lambda: build_support(
        pool, n=100_000, encoder=encoder))
    svc = RouterService(make_router("knn10", device="cuda"), engines, ds=ds,
                        encoder=encoder)
    for w in wrappers.values():
        w.launches = 0
    results = stage("serve_texts_s", lambda: svc.serve_texts(
        texts, lam=lams, max_new_tokens=8))
    launches = {n: w.launches for n, w in wrappers.items()}
    mix = {}
    for r in results:
        mix[r.model] = mix.get(r.model, 0) + 1
    assert all(r.request.done and r.request.error is None for r in results)
    assert not [r.uid for r in results if r.rerouted_from]
    assert all(len(r.request.output_tokens) == 8 for r in results)
    for r in results:
        vocab = engines[r.model].cfg.vocab_size
        assert all(0 <= t < vocab for t in r.request.output_tokens)

    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 50_000, 4 + 3 * (i % 6)) for i in range(16)]
    new = [4 + i % 5 for i in range(16)]
    t0 = time.perf_counter()
    alone = []
    for p, n in zip(prompts, new):
        req = Request(uid=0, prompt_tokens=p, max_new_tokens=n)
        mamba.run_until_drained([req])
        alone.append(req.output_tokens)
    t1 = time.perf_counter()
    reqs = [Request(uid=i, prompt_tokens=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new))]
    steps = mamba.run_until_drained(reqs)
    t2 = time.perf_counter()
    same = [r.output_tokens == a for r, a in zip(reqs, alone)]
    emit("mamba_serving", pool=pool, routing_mix=mix, stage_wall_s=stages,
         launches=launches, max_memory_allocated=torch.cuda.max_memory_allocated(),
         tokens=[r.request.output_tokens for r in results],
         isolation=dict(requests=16, slots=4, decode_waves_shared=steps,
                        alone_s=t1 - t0, shared_s=t2 - t1,
                        tokens_equal_to_alone=sum(same)))
    assert all(same), "a request's tokens depend on the other slots"

# ---------------------------------------------------------------------------
# phase 6: requests through the gateway (slice 8)
# ---------------------------------------------------------------------------

def http_get(port, path):
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, dict(r.getheaders()), json.loads(r.read())
    finally:
        c.close()


def sse_chat(port, model, text, max_tokens, timeout=300):
    """One streamed chat completion: (status, headers, served_by, tokens,
    final chunk's ``repro`` payload or the error body).  A stream must be
    well-formed: a role chunk, one content chunk a token, a stop chunk,
    then ``[DONE]``."""
    import http.client
    body = json.dumps({"model": model, "stream": True,
                       "max_tokens": max_tokens,
                       "messages": [{"role": "user", "content": text}]})
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", "/v1/chat/completions", body=body,
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        raw = r.read()
        headers = dict(r.getheaders())
    finally:
        c.close()
    if r.status != 200:
        return r.status, headers, None, None, json.loads(raw)
    frames = [ln[6:].decode() for ln in raw.split(b"\n")
              if ln.startswith(b"data: ")]
    assert frames and frames[-1] == "[DONE]", frames[-2:]
    chunks = [json.loads(f) for f in frames[:-1]]
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    final = chunks[-1]
    assert final["choices"][0]["finish_reason"] == "stop", final
    toks = [int(ch["choices"][0]["delta"]["content"]) for ch in chunks[1:-1]]
    assert len(toks) == max_tokens, (len(toks), max_tokens)
    served = final["repro"]["served_by"]
    assert headers["X-Repro-Served-By"] == served
    return r.status, headers, served, toks, final["repro"]


def concurrent(fn, args_list):
    """Run ``fn(*args)`` for each entry on its own thread, all released at
    once by a barrier; returns the results in order (a thread's exception
    is raised here)."""
    import threading
    barrier = threading.Barrier(len(args_list))
    out = [None] * len(args_list)

    def run(i, args):
        try:
            barrier.wait(60)
            out[i] = ("ok", fn(*args))
        except BaseException as exc:        # re-raised on the main thread
            out[i] = ("exc", exc)

    threads = [threading.Thread(target=run, args=(i, a), daemon=True)
               for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    for kind, val in out:
        if kind != "ok":
            raise val
    return [val for _, val in out]


def count_routes(router):
    """Wrap ``router.serve_fused`` to record each call's batch size; the
    returned function removes the wrapper."""
    inner = router.serve_fused
    sizes = []

    def counted(X, *a, **kw):
        sizes.append(len(X))
        return inner(X, *a, **kw)
    router.serve_fused = counted
    return sizes, lambda: router.__dict__.pop("serve_fused", None)


def assert_dark(port):
    import socket
    try:
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
    except OSError:
        return
    raise AssertionError(f"port {port} still accepts connections")


def kth_tie_error(np, k_s, k_i, p_s, p_i, rtol, atol):
    """Phase 4a's rule for two retrievals over a support of near-duplicate
    rows: the sorted scores agree within (rtol, atol), empty slots agree,
    and an id that only one of the two keeps scores (on the side that
    keeps it) within the tolerance of the row's k-th score, so the two
    kept different members of a tie at the k-th place.  Returns (max abs
    score error, ids kept by one side only, empty slots)."""
    fin = np.isfinite(p_s)
    assert (fin == np.isfinite(k_s)).all(), "empty slots differ"
    assert ((k_i < 0) == ~fin).all(), "ids of empty slots must be -1"
    err = float(np.abs(k_s - p_s)[fin].max()) if fin.any() else 0.0
    assert np.allclose(k_s[fin], p_s[fin], rtol=rtol, atol=atol), err
    swapped = 0
    for r in range(len(p_s)):
        score = {**dict(zip(p_i[r].tolist(), p_s[r].tolist())),
                 **dict(zip(k_i[r].tolist(), k_s[r].tolist()))}
        kth = float(p_s[r][fin[r]][-1]) if fin[r].any() else 0.0
        for i in set(k_i[r].tolist()) ^ set(p_i[r].tolist()):
            assert abs(score[i] - kth) <= atol + rtol * abs(kth), \
                ("an id kept by one side does not tie at the k-th", r, i)
            swapped += 1
    return err, swapped, int((~fin).sum())


def plain_search(torch, r, emb, backend="fused"):
    """The router's retrieval through the plain versions on the card, at
    its current ``nprobe`` / ``rerank``, on one snapshot of its index and
    the same coarse probe, clamping k and kk as `ivf_topk` / `ivfpq_topk`
    do: the plain IVF scan, or the plain ADC shortlist re-ranked exactly
    unless ``rerank`` is 0.  Over a streaming index's delta tier,
    ``fused`` scans the probed delta sub-lists (IVF-PQ re-ranks over the
    combined flat tier); ``host`` takes the base's result and merges an
    exact scan of the whole tier (`knn_topk_reference`), base first."""
    from repro_torch.kernels.knn_ivf.ops import (DynamicIVFIndex,
                                                 TierSnapshot,
                                                 rerank_stored_inv)
    from repro_torch.kernels.knn_ivf.ref import (ivf_probe, ivf_scan_plain,
                                                 ivfpq_adc_plain)
    from repro_torch.kernels.knn_topk.ref import knn_topk_reference
    idx = r._ivf
    snap = (idx.fused_state() if isinstance(idx, DynamicIVFIndex)
            else TierSnapshot(idx, None, idx.n_rows, 0))
    b, d = snap.base, snap.delta
    dl = d if backend == "fused" else None
    q = r._queries(emb)
    nprobe = max(1, min(r.nprobe, b.n_clusters))
    probe = ivf_probe(q, b.centroids, nprobe)
    cand = nprobe * (b.list_size + (snap.lc if dl is not None else 0))
    n = snap.n_rows if dl is not None else b.n_rows
    k = min(r.k, n, cand)
    if r.index == "ivf":
        sc, ix = ivf_scan_plain(q, probe, b.sup_cm, b.ids_cm, b.inv_cm, k, dl)
    else:
        kk = min(max(r.rerank, 1) * k, n, cand) if r.rerank else k
        sc, ix = ivfpq_adc_plain(q, probe, b.codes_cm, b.ids_cm, b.inv_cm,
                                 b.anchors, b.codebooks, kk, b.m, b.nbits,
                                 dl)
        if r.rerank:
            sup, inv = ((snap.sup_all, snap.inv_all) if dl is not None
                        else (b.sup_flat, b.inv_flat))
            sc, ix = rerank_stored_inv(q, sup, inv, ix, k)
    if dl is None and d is not None:
        k = min(r.k, snap.n_rows)
        if sc.shape[1] < k:
            pad = k - sc.shape[1]
            sc = torch.cat([sc, sc.new_full((len(q), pad), float("-inf"))], 1)
            ix = torch.cat([ix, ix.new_full((len(q), pad), -1)], 1)
        ds, di = knn_topk_reference(q, d.rows, min(k, d.rows.shape[0]))
        di = torch.where(di >= 0, di + d.n_base, di)
        cs, ci = torch.cat([sc[:, :k], ds], 1), torch.cat([ix[:, :k], di], 1)
        order = torch.sort(cs, dim=1, descending=True, stable=True).indices
        sc = torch.gather(cs, 1, order[:, :k])
        ix = torch.gather(ci, 1, order[:, :k])
        ix = torch.where(torch.isfinite(sc), ix, torch.full_like(ix, -1))
    return sc.cpu().numpy(), ix.cpu().numpy()


def tail_check(torch, np, r, out, k_s, k_i, lams):
    """``route_fused``'s output against the plain tail on the CPU fed with
    the kernel's own neighbours (phase 4a's rule: utilities, kth and
    agreement at 1e-5; a choice may differ only where two utilities tie).
    Returns (max error, choices equal to the tail's)."""
    from repro_torch.core.routers.knn import _serve_tail
    S, C = (torch.from_numpy(a) for a in (r._S, r._C))
    tail = [t.numpy() for t in _serve_tail(
        torch.from_numpy(k_s), torch.from_numpy(k_i), S, C,
        torch.from_numpy(lams), torch.ones(S.shape[1], dtype=torch.bool),
        weights=r.weights, temperature=float(r.temperature))]
    err = max(float(np.abs(a - b).max())
              for a, b in ((out[1], tail[1]), (out[2], tail[2]),
                           (out[3], tail[4])))
    util = tail[1] - lams[:, None] * tail[2]
    rows = np.arange(len(lams))
    err = max(err, float(np.abs(util[rows, out[0]]
                                - util[rows, tail[0]]).max()))
    assert err <= 1e-5, err
    return err, int((out[0] == tail[0]).sum())


def degraded_checks(torch, np, svc, emb, lams, level):
    """``route_fused(degrade=level)`` on the card: launches of kernels 4
    and 5 in the call, the kernel's neighbours against the plain versions
    on the card at the same degraded parameters and probe (phase 4a's
    tolerances and tie rule: `kth_tie_error`), the choices against the
    plain tail on the CPU fed with the kernel's own neighbours, and
    ``nprobe`` / ``rerank`` restored after."""
    from repro_torch.kernels.knn_ivf import ops as ivf_ops
    r = svc.router
    saved = (r.nprobe, r.rerank)
    lvl = svc.ladder[level]
    w4, w5 = ivf_ops.ivf_scan, ivf_ops.ivfpq_adc
    n4, n5 = w4.launches, w5.launches
    out = svc.route_fused(emb, lams, degrade=level)
    calls = {"ivf_topk": w4.launches - n4, "ivfpq_adc": w5.launches - n5}
    wrapper = w5 if r.index == "ivfpq" else w4
    cuda_launches = wrapper.last_cuda_launches
    assert (r.nprobe, r.rerank) == saved, "degraded() did not restore"
    with r.degraded(lvl):
        nprobe, rerank = r.nprobe, r.rerank
        k_s, k_i = r._neighbors(emb)
        p_s, p_i = plain_search(torch, r, emb)
    rtol = 1e-4 if r.index == "ivfpq" else 0.0
    err, swaps, empty = kth_tie_error(np, k_s, k_i, p_s, p_i, rtol, 1e-5)
    route_err, equal = tail_check(torch, np, r, out, k_s, k_i, lams)
    assert calls["ivfpq_adc" if r.index == "ivfpq" else "ivf_topk"] == 1, \
        calls
    return dict(level=level, name=lvl.name, nprobe=nprobe, rerank=rerank,
                wrapper_calls=calls, cuda_launches=cuda_launches,
                neighbour_max_abs_err=err, ids_kept_by_one_side=swaps,
                empty_slots=empty, route_max_abs_err=route_err,
                choices_equal=equal, restored=True)


def phase_gateway(torch, ctx, smi):
    """6: the port's `Gateway` over phase 4b's artifact-booted
    `knn100-ivfpq` service (full-width qwen3-4b and h2o-danube-1.8b, the
    100,000-row support) on 127.0.0.1 at an ephemeral port: health, one
    request alone, 16 concurrent streaming clients, overload, an outage,
    degraded routes, a `knn10` wave and shutdown.  Each step's kernel
    launch counters are zeroed before it and read after it.  Returns the
    phase's record."""
    import numpy as np
    from repro_torch.serving.faults import FaultInjector
    from repro_torch.serving.gateway import MODEL_PREFIX, Gateway
    from repro_torch.serving.router_service import RouterService

    t_phase = time.perf_counter()
    wrappers = kernel_wrappers()
    svc, encoder = ctx["ivfpq_svc"], ctx["encoder"]
    texts, lams = ctx["texts"], ctx["lams"]
    engines = svc.engines
    model = MODEL_PREFIX + svc.spec
    rec = {"card": smi}
    gateways = []

    def start(service, **kw):
        kw.setdefault("max_batch", 16)
        kw.setdefault("close_timeout_s", 0.01)
        kw.setdefault("max_pending", 32)
        g = Gateway(service, host="127.0.0.1", port=0, **kw).start()
        gateways.append(g)
        return g

    def counted(name, fn):
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        rec[name] = dict(wall_s=time.perf_counter() - t0, launches={
            n: w.launches for n, w in wrappers.items() if w.launches})
        return out

    def done(name):
        emit(f"gateway_{name}", **rec[name])

    # a. health and the model list
    gw = start(svc)
    status, _, health = http_get(gw.port, "/health")
    assert status == 200 and health["status"] == "ok", (status, health)
    status, _, models = http_get(gw.port, "/v1/models")
    assert status == 200 and [m["id"] for m in models["data"]] == [
        "repro/knn100-ivfpq"], models
    rec["a_health"] = dict(status=status, model=model,
                           port_ephemeral=gw.port)
    done("a_health")

    # b. one request alone against serve_texts of the same text and lambda
    _, _, served, toks, _ = counted("b_one_request", lambda: sse_chat(
        gw.port, f"{model}@lam=0.5", texts[1], 8))
    ref = svc.serve_texts([texts[1]], lam=0.5, max_new_tokens=8)[0]
    assert (served, toks) == (ref.model, ref.request.output_tokens), \
        (served, toks, ref.model, ref.request.output_tokens)
    rec["b_one_request"].update(served_by=served, tokens_equal=True)
    done("b_one_request")

    # c. 16 concurrent streaming clients, phase 4's texts and lambdas
    sizes, unwrap = count_routes(svc.router)
    flushes0 = gw.batcher.flushes
    try:
        outs = counted("c_concurrent_16", lambda: concurrent(
            lambda t, lam: sse_chat(gw.port, f"{model}@lam={float(lam)}", t,
                                    8),
            list(zip(texts, lams))))
    finally:
        unwrap()
    flushes = gw.batcher.flushes - flushes0
    emb = encoder.embed_texts(texts)
    direct = [svc.model_names[c] for c in svc.route_fused(emb, lams)[0]]
    served = [o[2] for o in outs]
    assert served == direct, (served, direct)
    assert all(o[0] == 200 and o[4]["rerouted_from"] == [] for o in outs)
    assert len(sizes) == flushes < 16, (sizes, flushes)
    assert sum(sizes) == 16, sizes
    missing = [n for n in ("flash_attention", "decode_attention",
                           "ivfpq_adc")
               if not rec["c_concurrent_16"]["launches"].get(n)]
    assert not missing, f"kernels not launched by the gateway: {missing}"
    _, _, st = http_get(gw.port, "/stats")
    json.dumps(st)
    rec["c_concurrent_16"].update(
        flushes=flushes, wave_sizes=sizes, served_by=served,
        ttft_p50_s=st["gateway"]["ttft_p50_s"],
        ttft_p99_s=st["gateway"]["ttft_p99_s"],
        ttft_window=st["gateway"]["ttft_window"])
    done("c_concurrent_16")

    # d. overload: a second gateway, max_pending 2, engines slowed
    slow = {m: FaultInjector(e, "latency", latency_s=2.0)
            for m, e in engines.items()}
    g2 = start(RouterService(svc.router, slow, encoder=encoder,
                             engine_timeout_s=ENGINE_TIMEOUT_S),
               max_pending=2)
    import socket
    held = []

    def hold(text):
        body = json.dumps({"model": model, "stream": True, "max_tokens": 2,
                           "messages": [{"role": "user", "content": text}]})
        s = socket.create_connection(("127.0.0.1", g2.port), timeout=60)
        s.sendall((f"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
        held.append(s)

    def wait_for(cond, what, timeout=60.0):
        t0 = time.monotonic()
        while not cond():
            assert time.monotonic() - t0 < timeout, f"timed out: {what}"
            time.sleep(0.005)

    hold(texts[0])                       # routed, then held by the latency
    wait_for(lambda: g2.batcher.flushes == 1, "the first wave")
    hold(texts[1])
    hold(texts[2])
    wait_for(lambda: g2.batcher.pending() == 2, "two queued requests")
    shed = []
    for t in texts[3:5]:
        status, headers, _, _, err = sse_chat(g2.port, model, t, 2)
        shed.append((status, headers.get("Retry-After"),
                     err["error"]["code"]))
    assert all(s == 429 and int(ra) >= 1 and code == "overloaded"
               for s, ra, code in shed), shed
    assert g2.batcher.shed == 2, g2.batcher.shed
    rec["d_overload"] = dict(max_pending=2, answers=shed,
                             shed=g2.batcher.shed,
                             latency_injected=sum(
                                 f.injected["latency"] for f in slow.values()))
    for sock in held:
        sock.close()
    g2.close()          # its waves share the engines: done before (e)
    done("d_overload")

    # e. outage: qwen3-4b raises (the other engine where no text chooses
    # it); a second service over the same router and engines with its own
    # breakers: one failure opens, and the backoff outlasts the two waves
    # below (up to 4 requests of 2 tokens each, about 2 s a wave here)
    victim = "qwen3-4b" if "qwen3-4b" in direct else direct[0]
    others = [m for m in svc.model_names if m != victim]
    chaos = FaultInjector(engines[victim], "raise")
    svc3 = RouterService(svc.router, {victim: chaos, others[0]:
                                      engines[others[0]]},
                         encoder=encoder, engine_timeout_s=ENGINE_TIMEOUT_S,
                         breaker={"failure_threshold": 1,
                                  "base_backoff_s": 10.0})
    g3 = start(svc3)
    pick = [i for i, m in enumerate(direct) if m == victim][:4]
    outs = counted("e_outage", lambda: concurrent(
        lambda t, lam: sse_chat(g3.port, f"{model}@lam={float(lam)}", t, 2),
        [(texts[i], lams[i]) for i in pick]))
    assert all(o[2] == others[0] and o[4]["rerouted_from"] == [victim]
               for o in outs), outs
    status, _, health = http_get(g3.port, "/health")
    assert status == 503 and health["status"] == "degraded", health
    assert health["engines"][victim]["state"] == "open", health
    t_next = time.perf_counter()
    nxt = concurrent(lambda t, lam: sse_chat(
        g3.port, f"{model}@lam={float(lam)}", t, 2),
        [(texts[i], lams[i]) for i in pick])
    assert all(o[2] != victim and o[4]["rerouted_from"] == []
               for o in nxt), nxt
    next_wall = time.perf_counter() - t_next
    raised = chaos.injected["raise"]
    chaos.heal()
    time.sleep(svc3.health[victim].retry_after_s() + 0.05)
    status, _, health = http_get(g3.port, "/health")
    assert status == 200 and health["status"] == "ok", health
    rec["e_outage"].update(victim=victim, requests=len(pick),
                           next_wave_wall_s=next_wall,
                           rerouted_to=others[0],
                           health_while_open=503, next_wave_to_victim=0,
                           injected_raises=raised, health_after_heal=status)
    done("e_outage")

    # f. degraded routes on knn100-ivf and knn100-ivfpq
    deg = {}
    for name, s in (("knn100-ivf", ctx["ivf_svc"]), ("knn100-ivfpq", svc)):
        deg[name] = [counted(f"f_{name}_L{L}", lambda: degraded_checks(
            torch, np, s, emb, lams, L)) for L in (1, 2, 3)]
    rec["f_degraded"] = deg
    emit("gateway_f_degraded", **deg)

    # g. one wave of the knn10 service (exact top-k): the wave closes full
    knn10 = ctx["knn10_svc"]
    g4 = start(knn10, close_timeout_s=30.0)
    outs = counted("g_knn10_wave", lambda: concurrent(
        lambda t, lam: sse_chat(g4.port, f"{MODEL_PREFIX}{knn10.spec}"
                                f"@lam={float(lam)}", t, 4),
        list(zip(texts, lams))))
    direct10 = [knn10.model_names[c]
                for c in knn10.route_fused(emb, lams)[0]]
    assert [o[2] for o in outs] == direct10
    assert g4.batcher.flushes == 1, g4.batcher.flushes
    assert rec["g_knn10_wave"]["launches"].get("knn_topk") == 1, rec
    rec["g_knn10_wave"].update(flushes=g4.batcher.flushes,
                               served_by=[o[2] for o in outs])
    done("g_knn10_wave")

    # h. shutdown: both threads joined, every port dark
    for g in gateways:
        g.close()
        assert not g._pump_thread.is_alive() and \
            not g._http_thread.is_alive()
        assert_dark(g.port)
    rec["h_shutdown"] = dict(gateways=len(gateways), threads_joined=True,
                             ports_dark=True)
    rec["wall_s"] = time.perf_counter() - t_phase
    emit("gateway", **rec)
    assert rec["wall_s"] < 120, rec["wall_s"]
    return rec


# ---------------------------------------------------------------------------
# phase 7: streaming and recovery on the card (slice 9)
# ---------------------------------------------------------------------------

#: phase 7's new topic, judged with the reference kill child's recipe: the
#: observed rows score HOT_SCORE on h2o-danube-1.8b
NEW_TOPIC = "lattice cryptography"
HOT_SCORE = 9.0
PHASE7_BUDGET_S = 150.0


def timed_attr(obj, name, bucket):
    """Wrap ``obj.name`` to append each call's wall seconds to ``bucket``;
    returns the function that removes the wrapper."""
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        bucket.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, wrapper)
    return lambda: obj.__dict__.pop(name, None)


def dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_streaming(torch, ctx, smi):
    """7: streaming and recovery on the card, at full width, on phase 4's
    engines, encoder and support: a durable service booted from phase 4b's
    `knn100-ivfpq` artifact (a `DurabilityManager` over a directory under
    build/) and phase 4b's `knn100-ivf` router.  a. boot and the bootstrap
    checkpoint; b. observe 64 texts (phase 4's topics and a new one judged
    for h2o-danube-1.8b), then route 32 texts: kernel 5 in one call of one
    CUDA launch over base plus delta, against the plain version, each
    observed text finding its own row, choices against the plain tail, the
    new topic choosing h2o-danube-1.8b; c. `knn100-ivf` on both semantics;
    d. ``degrade=3``; e. compaction while a second thread routes, the
    compacted base against a fresh build (after it, in this process) byte
    for byte and its routes against a router over that build bitwise; f. close and recover, routes
    bitwise equal; g. the recovered service behind the `Gateway`, a drain
    writing the final checkpoint; h. the walls.  Each step's launch
    counters are zeroed before it and read after it."""
    import shutil
    import threading
    import numpy as np
    from repro_torch.core.routers import make_router
    from repro_torch.kernels.knn_ivf import ops as ivf_ops
    from repro_torch.launch.serve import TOPICS
    from repro_torch.serving.durability import DurabilityManager
    from repro_torch.serving.gateway import MODEL_PREFIX, Gateway
    from repro_torch.serving.router_service import RouterService

    t_phase = time.perf_counter()
    wrappers = kernel_wrappers()
    engines, encoder = ctx["engines"], ctx["encoder"]
    texts, lams = ctx["texts"], ctx["lams"]
    rec = {"card": smi}

    def counted(name, fn):
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        rec[name] = dict(wall_s=time.perf_counter() - t0, launches={
            n: w.launches for n, w in wrappers.items() if w.launches})
        return out

    # a. boot: the bootstrap checkpoint
    state = ROOT / "build" / "chip_smoke" / "state"
    shutil.rmtree(state, ignore_errors=True)
    dur = DurabilityManager(state, device="cuda")
    svc = counted("a_boot", lambda: RouterService.from_artifact(
        ctx["ivfpq_path"], engines, device="cuda", encoder=encoder,
        durability=dur, engine_timeout_s=ENGINE_TIMEOUT_S))
    r = svc.router
    assert dur.checkpoints_written == 1
    rec["a_boot"].update(bootstrap_checkpoint_bytes=dir_bytes(
        dur.checkpoints.dir))
    emit("streaming_a_boot", **rec["a_boot"])

    # b. observe 64 texts, then route 32
    new_texts = [f"{NEW_TOPIC} feedback {i}" for i in range(16)]
    old_texts = [f"{TOPICS[i % len(TOPICS)]} feedback {i}" for i in range(48)]
    fb_texts = old_texts + new_texts
    fb_scores = np.tile(np.array([[0.2, HOT_SCORE]], np.float32), (64, 1))
    assert svc.model_names == ["qwen3-4b", "h2o-danube-1.8b"], \
        svc.model_names
    log_s, append_s, ckpt_s = [], [], []
    undo = [timed_attr(dur, "log", log_s),
            timed_attr(r, "partial_fit", append_s),
            timed_attr(dur, "checkpoint", ckpt_s)]
    support = counted("b_observe_64", lambda: svc.observe(fb_texts,
                                                          fb_scores))
    n_base = r._ivf.fused_state().base.n_rows
    assert support == n_base + 64 and r._ivf.delta_rows == 64
    route_texts = texts + new_texts
    emb = encoder.embed_texts(route_texts)
    lam32 = np.concatenate([lams, np.zeros(16, np.float32)])
    out = counted("b_route_32", lambda: svc.route_fused(emb, lam32))
    snap = r._ivf.fused_state()
    d = snap.delta
    assert r.resolve_backend(32) == "fused"
    assert rec["b_route_32"]["launches"].get("ivfpq_adc") == 1, rec
    assert ivf_ops.ivfpq_adc.last_cuda_launches == 1
    assert ivf_ops.fused_fits(snap.base.m, snap.base.nbits,
                              snap.base.codes_cm.shape[1],
                              snap.base.list_size, r.nprobe,
                              min(r.rerank * r.k, snap.n_rows), d.lmax)
    k_s, k_i = r._neighbors(emb, "fused")
    p_s, p_i = plain_search(torch, r, emb, "fused")
    err, swaps, _ = kth_tie_error(np, k_s, k_i, p_s, p_i, 1e-4, 1e-5)
    own = n_base + 48 + np.arange(16)
    for i, row in enumerate(own):
        hit = k_i[16 + i] == row
        assert hit.any() and float(k_s[16 + i][hit][0]) >= 0.999, \
            ("an observed text does not find its own row", i)
    route_err, _ = tail_check(torch, np, r, out, k_s, k_i, lam32)
    chose = [svc.model_names[c] for c in out[0][16:]]
    assert chose == ["h2o-danube-1.8b"] * 16, chose
    rec["b_route_32"].update(
        neighbour_max_abs_err=err, ids_kept_by_one_side=swaps,
        route_max_abs_err=route_err, own_rows_found=16,
        new_topic_choices=chose[0], delta_rows=int(d.rows.shape[0]),
        lmax=int(d.lmax), cuda_launches_of_ivfpq_adc=1)
    emit("streaming_b_observe_route", observe=rec["b_observe_64"],
         route=rec["b_route_32"], wal_fsync_s=log_s, append_s=append_s)

    # c. knn100-ivf on both semantics, with the same 64 rows observed
    ivf_r = ctx["ivf_svc"].router
    ivf_svc = RouterService(ivf_r, engines, encoder=encoder)
    ivf_svc.observe(fb_texts, fb_scores)
    c_rec = {}
    for be, kern in (("fused", ("ivf_topk",)),
                     ("host", ("ivf_topk", "knn_topk"))):
        k_s, k_i = counted(f"c_ivf_{be}", lambda: ivf_r._neighbors(emb, be))
        got = rec[f"c_ivf_{be}"]["launches"]
        assert all(got.get(n) == 1 for n in kern), (be, got)
        if be == "fused":
            assert ivf_ops.ivf_scan.last_cuda_launches == 1
        p_s, p_i = plain_search(torch, ivf_r, emb, be)
        err, swaps, _ = kth_tie_error(np, k_s, k_i, p_s, p_i, 0.0, 1e-5)
        c_rec[be] = dict(rec[f"c_ivf_{be}"], neighbour_max_abs_err=err,
                         ids_kept_by_one_side=swaps,
                         delta_ids_in_result=int((k_i >= ivf_r._ivf.fused_state()
                                                  .base.n_rows).sum()))
    emit("streaming_c_ivf_semantics", **c_rec)

    # d. degrade=3 serves the base only
    deg = counted("d_degrade_3", lambda: svc.route_fused(emb, lam32,
                                                         degrade=3))
    with r.degraded(svc.ladder[3]):
        _, d_i = r._neighbors(emb, "fused")
    assert (d_i < n_base).all(), "a degraded route retrieved delta rows"
    assert rec["d_degrade_3"]["launches"].get("ivfpq_adc") == 1
    emit("streaming_d_degrade_3", **rec["d_degrade_3"],
         observed_rows_retrieved=0,
         choices=[svc.model_names[c] for c in deg[0][16:20]])

    # e. compaction while a second thread routes the 32 texts
    stop, errors, walls = threading.Event(), [], []

    def router_loop():
        while not stop.is_set():
            try:
                t0 = time.perf_counter()
                pending = r._ivf.recluster_pending
                svc.route_fused(emb, lam32)
                walls.append((pending and r._ivf.recluster_pending,
                              time.perf_counter() - t0))
            except Exception as exc:              # raised below
                errors.append(exc)
                return
            # a route every 100 ms: the rebuild's numpy loops need the GIL
            # (a route every 5 ms tripled the compaction's wall on the card)
            time.sleep(0.1)

    rng = np.random.default_rng(19)
    batches = []
    for bi in range(9):
        tx = [f"{TOPICS[(bi + i) % len(TOPICS)]} stream {bi} {i}"
              for i in range(512)]
        batches.append((encoder.embed_texts(tx),
                        rng.uniform(0.2, 1.0, (512, 2)).astype(np.float32)))
    for w in wrappers.values():
        w.launches = 0
    t_e = time.perf_counter()
    th = threading.Thread(target=router_loop, daemon=True)
    th.start()
    rows = None
    try:
        for bi, (X, S) in enumerate(batches[:8]):
            svc.observe(X, S)
            if r._ivf.recluster_pending and rows is None:
                rows = r._ivf.all_rows()
                t_rc = time.perf_counter()
        assert rows is not None, "no compaction started"
        r.join_recluster()
        compaction_s = time.perf_counter() - t_rc
    finally:
        stop.set()
        th.join(120)
    assert not errors, errors
    during = sum(1 for p, _ in walls if p)
    assert during >= 1, "no route landed during the rebuild"
    assert r._ivf.delta_rows == 0 and r._ivf.reclusters == 1
    # a fresh build over the same rows, in this process after the
    # compaction: a build with another BLAS thread count (a subprocess with
    # one thread) gave other lists, and one beside the compaction slowed
    # both 2.4x on the card's host
    t_f = time.perf_counter()
    fr = make_router("knn100-ivfpq", device="cuda")
    kw = r._ivf.build_kw
    fr._ivf = ivf_ops.build_ivfpq_index(
        rows, n_clusters=kw.get("n_clusters"), m=kw.get("m"),
        nbits=kw.get("nbits", 8), seed=kw.get("seed", 0),
        lane_pad=kw.get("lane_pad", 8), device="cuda")
    fresh_build_s = time.perf_counter() - t_f
    base = r._ivf.fused_state().base
    for h in ("centroids_h", "anchors_h", "codes_h", "ids_h", "inv_h",
              "codebooks_h", "sup_flat_h"):
        assert np.array_equal(getattr(fr._ivf, h), getattr(base, h)), \
            f"the compacted {h} differs from a fresh build"
    for a in ("model_names", "embed_dim", "fit_seed", "default_lam", "_X",
              "_S", "_C"):
        setattr(fr, a, getattr(r, a))
    live, other = r.serve_fused(emb, lam32), fr.serve_fused(emb, lam32)
    assert all(np.array_equal(a, b) for a, b in zip(live, other)), \
        "the compacted router routes differently from a fresh build"
    ln, fn_ = r._neighbors(emb, "fused"), fr._neighbors(emb, "fused")
    assert all(np.array_equal(a, b) for a, b in zip(ln, fn_))
    e_walls = sorted(w for _, w in walls)
    rec["e_compaction"] = dict(
        wall_s=time.perf_counter() - t_e, compaction_s=compaction_s,
        fresh_build_s=fresh_build_s, routes=len(walls),
        routes_during_rebuild=during,
        route_wall_median_s=e_walls[len(e_walls) // 2],
        launches={n: w.launches for n, w in wrappers.items() if w.launches},
        delta_rows_peak=64 + 8 * 512, base_rows_after=base.n_rows,
        fresh_build_bytes_equal=True, fresh_router_routes_bitwise_equal=True)
    emit("streaming_e_compaction", **rec["e_compaction"])
    # the ninth batch lands on the compacted base (and writes the
    # checkpoint the compaction asked for)
    counted("e_ninth_batch", lambda: svc.observe(*batches[8]))
    occupancy = r._ivf.delta_occupancy()
    delta_bytes = r._ivf.delta_device_bytes

    # f. one more batch, close, recover on the card
    X = encoder.embed_texts([f"{NEW_TOPIC} late {i}" for i in range(32)])
    svc.observe(X, np.tile(np.array([[0.2, HOT_SCORE]], np.float32),
                           (32, 1)))
    before = (svc.route_fused(emb, lam32), r._neighbors(emb, "fused"),
              r.support_size)
    svc.close()
    dur.close()
    for u in undo:
        u()
    svc2 = counted("f_recover", lambda: RouterService.recover(
        state, engines, device="cuda", encoder=encoder,
        engine_timeout_s=ENGINE_TIMEOUT_S))
    st = svc2.recovery_status()
    assert st["status"] == "ready" and st["replayed_batches"] >= 1, st
    assert svc2.router.support_size == before[2]
    after = (svc2.route_fused(emb, lam32), svc2.router._neighbors(emb,
                                                                  "fused"))
    for a, b in zip(before[0] + before[1], after[0] + after[1]):
        assert np.array_equal(a, b), "the recovered service routes otherwise"
    rec["f_recover"].update(recovery=st, support_size=before[2],
                            routes_bitwise_equal=True)
    emit("streaming_f_recover", **rec["f_recover"])

    # g. the recovered service behind the gateway; a drain's checkpoint
    gw = Gateway(svc2, host="127.0.0.1", port=0, max_batch=16,
                 close_timeout_s=0.01, max_pending=32).start()
    try:
        status, _, health = http_get(gw.port, "/health")
        assert status == 200 and health["status"] == "ok", (status, health)
        _, _, stats = http_get(gw.port, "/stats")
        assert stats["service"]["durability"]["checkpoints"]["on_disk"] >= 1
        model = MODEL_PREFIX + svc2.spec
        _, _, served, toks, _ = counted("g_one_request", lambda: sse_chat(
            gw.port, f"{model}@lam=0.5", new_texts[0], 8))
        ref = svc2.serve_texts([new_texts[0]], lam=0.5, max_new_tokens=8)[0]
        assert (served, toks) == (ref.model, ref.request.output_tokens)
        n_ck = svc2.durability.checkpoints_written
        gw.begin_drain()
        gw.drain(timeout_s=30.0)
        assert svc2.durability.checkpoints_written == n_ck + 1
    finally:
        gw.close()
    assert_dark(gw.port)
    rec["g_gateway"] = dict(health=200, served_by=served, tokens_equal=True,
                            drain_checkpoint_written=True)
    emit("streaming_g_gateway", **rec["g_gateway"])

    # h. the walls: the recovered router (a tier of 544 rows) and the
    # router over the fresh build (no tier)
    assert svc2.router._ivf.delta_rows == 512 + 32
    with_delta = route_walls(torch, lambda: svc2.router.serve_fused(
        emb, lam32))
    no_delta = route_walls(torch, lambda: fr.serve_fused(emb, lam32))
    wall = time.perf_counter() - t_phase
    emit("streaming_h_walls", card=smi,
         observe_batch_s=rec["b_observe_64"]["wall_s"],
         observe_wal_fsync_s=log_s, observe_append_s=append_s,
         checkpoint_s=ckpt_s, route_with_delta_s=with_delta,
         route_without_delta_s=no_delta, compaction_s=compaction_s,
         recover_s=rec["f_recover"]["wall_s"],
         bootstrap_checkpoint_s=rec["a_boot"]["wall_s"],
         delta_device_bytes=delta_bytes,
         delta_occupancy_max=int(occupancy.max()),
         delta_rows_at_close=int(svc2.router._ivf.delta_rows),
         phase_wall_s=wall, budget_s=PHASE7_BUDGET_S)
    svc2.durability.close()
    assert wall < PHASE7_BUDGET_S, f"phase 7 took {wall:.1f} s"
    return rec


# ---------------------------------------------------------------------------
# phase 8: the paper's evaluation on the card (slice 10)
# ---------------------------------------------------------------------------

PHASE8_BUDGET_S = 150.0
#: Table 2's columns that run every router of the paper's order; the other
#: columns run the kNN routers and the linear one
TABLE2_FULL = ("AlpacaEval/OpenAI", "HELM-Lite/Google", "RouterBench")
TABLE2_LIGHT = ("knn10", "knn100", "linear")
TABLE5 = ("knn10", "knn100", "linear", "mlp")
TABLE_D = ("knn100", "linear", "mlp")
#: test rows each learned router's card forward is held against the CPU
#: forward on (the CPU side of the check is the costly one)
CPU_ROWS = 128
#: learned routers' card forward against the CPU forward at the card's
#: weights: f32 with TF32 off, products summed in another order
LEARNED_TOL = 1e-4


class PlainGuard:
    """Counts the calls of kernel 1's plain version that reach it through
    the wrapper with a CUDA tensor (``cuda_calls`` must stay 0), and keeps
    the self-queries (Q = N) the neighbour routers' fits run through the
    kernel: (queries, support, k, ids) on the card."""

    def __init__(self, knn_ops, graph_mod):
        self.knn_ops, self.graph_mod = knn_ops, graph_mod
        self.cuda_calls = 0
        self.self_queries = []
        self.plain, self.kernel = knn_ops.knn_topk_reference, graph_mod.knn_topk

        def plain(q, s, k):
            self.cuda_calls += int(q.is_cuda)
            return self.plain(q, s, k)

        def kernel(q, s, k):
            out = self.kernel(q, s, k)
            if q.shape[0] == s.shape[0]:
                self.self_queries.append((q, s, k, out))
            return out
        knn_ops.knn_topk_reference = plain
        graph_mod.knn_topk = kernel

    def close(self):
        self.knn_ops.knn_topk_reference = self.plain
        self.graph_mod.knn_topk = self.kernel


def self_query_check(torch, np, q, s, k, out):
    """One fit's self-query on the card against the plain version on the
    card, outside ties (phase 4a's rule), and the share of rows whose first
    neighbour, the one the fit drops, is the row itself, on both."""
    from repro_torch.kernels.knn_topk.ref import knn_topk_reference
    ref = knn_topk_reference(q, s, k)
    ks, ki, ps, pi = (t.cpu().numpy() for t in (*out, *ref))
    err, swapped, _ = kth_tie_error(np, ks, ki, ps, pi, 1e-5, 1e-5)
    rows = np.arange(len(ki))
    return dict(Q=int(q.shape[0]), N=int(s.shape[0]), k=int(k),
                max_abs_err=err, ids_swapped_in_ties=swapped,
                self_top1_share_kernel=float((ki[:, 0] == rows).mean()),
                self_top1_share_plain=float((pi[:, 0] == rows).mean()))


def cpu_twin(router, spec):
    """A CPU router of the same spec holding the card router's state."""
    from repro_torch.core.routers import make_router
    twin = make_router(spec, device="cpu")
    twin.load_state_dict(router.state_dict())
    twin.model_names, twin.embed_dim = router.model_names, router.embed_dim
    return twin


def knn_cpu_check(torch, np, router, spec, X):
    """8d for a kNN router: its neighbours on the card against the CPU
    path's (the plain version) outside ties, and the card's s_hat / c_hat
    against the CPU tail fed with the card's neighbours (1e-5)."""
    twin = cpu_twin(router, spec)
    ks, ki = router._neighbors(X)
    ps, pi = twin._neighbors(X)
    err, swapped, empty = kth_tie_error(np, ks, ki, ps, pi, 1e-5, 1e-5)
    s, c = router.predict_utility(X)
    ts, tc = twin._utility_from(ks, ki)
    u_err = max(float(np.abs(s - ts).max()), float(np.abs(c - tc).max()))
    assert u_err <= 1e-5, u_err
    return dict(nbr_max_abs_err=err, ids_swapped_in_ties=swapped,
                utility_max_abs_err=u_err)


def learned_cpu_check(torch, np, router, spec, X, c_ref):
    """8d for a learned router: the fitted state copied to a CPU router,
    whose forward on ``X`` is held against the card's within LEARNED_TOL
    (costs over ``c_ref``).  A neighbour router's CPU twin takes the card's
    neighbour ids, which are held against the plain version on the CPU
    outside ties."""
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_reference
    from repro_torch.core.routers.base import normalize_rows
    twin = cpu_twin(router, spec)
    out = {}
    if hasattr(router, "_nbrs"):
        q = torch.from_numpy(normalize_rows(X))
        k = min(router.k, len(router._X))
        ks, ki = knn_topk(q.cuda(), router._dev_of("_X"), k)
        ps, pi = knn_topk_reference(q, torch.from_numpy(twin._X), k)
        err, swapped, _ = kth_tie_error(np, ks.cpu().numpy(),
                                        ki.cpu().numpy(), ps.numpy(),
                                        pi.numpy(), 1e-5, 1e-5)
        out.update(nbr_max_abs_err=err, ids_swapped_in_ties=swapped)
        card_idx = ki.cpu().long()
        twin._nbrs = lambda X_, exclude_self=False: card_idx
    s, c = router.predict_utility(X)
    ts, tc = twin.predict_utility(X)
    err = max(float(np.abs(s - ts).max()),
              float(np.abs(c - tc).max()) / c_ref)
    assert err <= LEARNED_TOL, (spec, err)
    out["forward_max_err"] = err
    return out


def phase_evaluation(torch, smi):
    """8: the paper's evaluation on the card.  The seeded suite
    (`full_suite`, `vlm_benchmarks`) is generated; a. Table 2's protocol
    through `RoutingPipeline(spec, seed=0).fit(ds).evaluate()`: the 12
    routers of `PAPER_ORDER` on AlpacaEval/OpenAI, HELM-Lite/Google and
    RouterBench, `knn10`, `knn100` and `linear` on the other 7 columns;
    b. Table 5's first column (D = 3,584) with `knn10`, `knn100`, `linear`
    and `mlp`; c. Table D's `selection_utility` for `knn100`, `linear` and
    `mlp` on HELM-Lite/Google; d. the checks, each failing the run: every
    kNN AUC in (random, oracle + 1e-6]; the kNN routers' neighbours and
    utilities against the CPU path on the same fit; each learned router's
    state copied to a CPU router whose forward matches the card's; each
    trained fit's last loss finite and below its first; every neighbour
    router's self-query against the plain version outside ties; no plain
    version of kernel 1 reached with a CUDA tensor.  Kernel 1's launches
    are counted per fit and per evaluate; a graph10 fit of 5 epochs is
    profiled."""
    import numpy as np
    from repro_torch.core import eval as E
    from repro_torch.core.routers import PAPER_ORDER, make_router
    from repro_torch.core.routers import graph as graph_mod
    from repro_torch.data.routing_bench import full_suite, vlm_benchmarks
    from repro_torch.kernels.knn_topk import ops as knn_ops
    from repro_torch.serving.pipeline import RoutingPipeline

    t_phase = time.perf_counter()
    suite = full_suite()
    t_text = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    vlm = vlm_benchmarks()
    t_vlm = time.perf_counter() - t0
    emit("eval_suite", card=smi, text_columns=len(suite),
         vlm_columns=len(vlm), full_suite_s=t_text, vlm_benchmarks_s=t_vlm,
         shapes={n: list(d.embeddings.shape) for n, d in
                 [*suite.items(), *list(vlm.items())[:1]]})
    knn = knn_ops.knn_topk
    guard = PlainGuard(knn_ops, graph_mod)
    table, refs, fits, walls = {}, {}, {}, {}

    def pair(col, ds, spec):
        if col not in refs:
            refs[col] = (E.oracle_auc(ds)["auc"], E.random_auc(ds)["auc"])
        oracle, rand = refs[col]
        n_self = len(guard.self_queries)
        knn.launches = 0
        t0 = time.perf_counter()
        pipe = RoutingPipeline(spec, seed=0).fit(ds)
        torch.cuda.synchronize()
        fit_s, fit_launches = time.perf_counter() - t0, knn.launches
        knn.launches = 0
        t0 = time.perf_counter()
        auc = pipe.evaluate()["auc"]
        eval_s, eval_launches = time.perf_counter() - t0, knn.launches
        r = pipe.router
        rec = dict(column=col, spec=spec, auc=auc, oracle_auc=oracle,
                   random_auc=rand, fit_s=fit_s, evaluate_s=eval_s,
                   knn_topk_launches_fit=fit_launches,
                   knn_topk_launches_evaluate=eval_launches)
        X = ds.part("test")[0]
        t0 = time.perf_counter()
        if spec.startswith("knn"):
            assert rand < auc <= oracle + 1e-6, rec
            assert eval_launches == 1 and fit_launches == 0, rec
            rec.update(knn_cpu_check(torch, np, r, spec, X))
        else:
            rec.update(learned_cpu_check(torch, np, r, spec, X[:CPU_ROWS],
                                         ds.c_max))
            if hasattr(r, "train_losses"):
                first, last = r.train_losses
                assert math.isfinite(last) and last < first, rec
                rec.update(loss_first=first, loss_last=last)
            if hasattr(r, "_nbrs"):
                assert fit_launches == 1 and eval_launches == 1, rec
                (q, s, k, out), = guard.self_queries[n_self:]
                rec["self_query"] = self_query_check(torch, np, q, s, k, out)
            del guard.self_queries[n_self:]
        rec["check_s"] = time.perf_counter() - t0
        emit("eval_pair", **rec)
        table.setdefault(col, {})[spec] = auc
        fits.setdefault(spec, []).append(fit_s)
        for key in ("fit_s", "evaluate_s", "check_s"):
            walls[key] = walls.get(key, 0.0) + rec[key]
        return r

    try:
        # a. Table 2's protocol
        for col in TABLE2_FULL:
            for spec in PAPER_ORDER:
                pair(col, suite[col], spec)
        for col in suite:
            if col not in TABLE2_FULL:
                for spec in TABLE2_LIGHT:
                    pair(col, suite[col], spec)
        # b. Table 5's first column
        vcol = next(iter(vlm))
        for spec in TABLE5:
            pair(vcol, vlm[vcol], spec)
        # c. Table D on HELM-Lite/Google
        ds = suite["HELM-Lite/Google"]
        sel = {}
        for spec in TABLE_D:
            made = []

            def factory():
                made.append(make_router(spec))
                return made[-1]
            t0 = time.perf_counter()
            sel[spec] = E.selection_utility(factory, ds)
            walls["table_d_s"] = walls.get("table_d_s", 0.0) \
                + time.perf_counter() - t0
            rec = dict(spec=spec, utility=sel[spec],
                       wall_s=time.perf_counter() - t0)
            assert all(math.isfinite(v) for v in sel[spec].values()), rec
            for r in made:
                if hasattr(r, "train_losses"):
                    first, last = r.train_losses
                    assert math.isfinite(last) and last < first, rec
            emit("eval_table_d", column="HELM-Lite/Google", **rec)
        # one learned fit under the profiler: device idle share; 5 of the
        # default 60 epochs, since reading a trace of a whole fit's 130,000
        # kernels took the host ~15 s a window
        t0 = time.perf_counter()
        prof = device_profile(
            torch, lambda: make_router("graph10", epochs=5).fit(ds), top=6,
            groups={"knn_topk": "knn_"}, require="knn_topk")
        walls["profile_s"] = time.perf_counter() - t0
        emit("eval_profile", card=smi,
             fit="graph10@epochs=5 on HELM-Lite/Google", **prof)
    finally:
        guard.close()
    assert guard.cuda_calls == 0, guard.cuda_calls
    wall = time.perf_counter() - t_phase
    # what the paper claims, recorded, not checked: the best kNN AUC of a
    # column against its best learned one
    verdict = {}
    for col, aucs in table.items():
        learned = {s: a for s, a in aucs.items() if not s.startswith("knn")}
        best_knn = max(a for s, a in aucs.items() if s.startswith("knn"))
        best = max(learned, key=learned.get)
        verdict[col] = dict(best_knn=best_knn, best_learned=learned[best],
                            best_learned_spec=best,
                            knn_minus_learned=best_knn - learned[best])
    emit("eval_table2", card=smi, auc=table, verdict=verdict,
         oracle_random={c: dict(oracle=o, random=r)
                        for c, (o, r) in refs.items()})
    emit("eval_walls", card=smi, fit_s_by_router=fits, sums_s=walls,
         plain_cuda_calls=guard.cuda_calls, phase_wall_s=wall,
         budget_s=PHASE8_BUDGET_S)
    assert wall < PHASE8_BUDGET_S, f"phase 8 took {wall:.1f} s"


# ---------------------------------------------------------------------------
# phase 9: the other text families train and serve (slice 11)
# ---------------------------------------------------------------------------

PHASE9_BUDGET_S = 150.0
#: 9a: danube at its published widths and depth, TRAIN_4K's length
TRAIN9 = dict(arch="h2o-danube-1.8b", steps=10, batch=2, seq=4096)
#: 9b: (arch, depth cut: layers, or groups of the pattern, None = full,
#: dtype of the forward-against-decode check).  Widths are the published
#: ones; the cuts keep each model's weights and caches on one 80 GB card
#: (qwen1.5-32b at 64 layers is ~70 GB in bf16) and the phase in its
#: budget.  The check runs in f32 where the model fits the card in f32
#: (llama4-maverick's 128 experts take 64 GB in f32: bf16 there)
SERVE9 = [("zamba2-7b", None, "float32"), ("starcoder2-15b", 8, "float32"),
          ("qwen1.5-32b", 8, "float32"), ("deepseek-v2-236b", 2, "float32"),
          ("llama4-maverick-400b-a17b", 1, "bfloat16")]
#: 9b's forward-against-decode limits: the largest relative L2 distance
#: ||decode - forward|| / ||forward|| of one position's logits, over the
#: positions whose MoE routes agree.  In f32 phase 5b's 2e-3 (the CPU
#: parity tests hold 1e-4 at reduced depth); in bf16 0.05: the two paths
#: round in other places (2^-8 a rounding) and the dense 8-layer models
#: read ~0.011 in bf16 on an H100, while logits of a wrong mask,
#: position or cache are uncorrelated with the forward's (~sqrt(2)).  A
#: route that differs (a near-tie of router logits ordered otherwise by
#: the paths' roundings) is counted and may take at most 10% of positions
DECODE9_TOL = {"float32": 2e-3, "bfloat16": 0.05}
DECODE9_MAX_FLIPS = 0.10


def depth_cut(cfg, n):
    """``cfg`` with ``n`` groups of its pattern (n layers for a one-layer
    pattern), no tail; None keeps it whole."""
    if n is None:
        return cfg
    return cfg.replace(n_groups=n, n_layers=n * len(cfg.pattern),
                       tail_pattern=(), n_tail_groups=0)


def refuse_plain_on_cuda(torch):
    """Patch the flash kernels' plain versions to fail on a CUDA tensor;
    returns the undo."""
    from repro_torch.kernels.flash_attention import ops as fops
    saved = {n: getattr(fops, n) for n in ("flash_attention_reference",
                                           "flash_attention_bwd_plain")}

    def guard(name):
        def fn(*a, **kw):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                raise AssertionError(f"{name} reached with a CUDA tensor")
            return saved[name](*a, **kw)
        return fn
    for n in saved:
        setattr(fops, n, guard(n))
    return lambda: [setattr(fops, n, f) for n, f in saved.items()]


def phase_train_attention(torch, wrappers):
    """9a: `repro_torch.launch.train.main --arch h2o-danube-1.8b` at its
    published widths and depth (24 layers, hd 80, window 4,096) in bf16,
    10 steps of batch 2 x 4,096 with per-layer remat, `--ckpt` into the
    git-ignored build directory; the counters zeroed just before and read
    just after.  The loss must stay finite and fall; kernel 2 runs twice a
    layer and step (forward and the remat's recompute), kernel 2b once; no
    plain attention is reached with a CUDA tensor.  The checkpoint is read
    back through the port's reader, bitwise equal to the trained weights.
    Then one more step of the trained model under `torch.profiler`:
    device time by kernel, idle share."""
    import numpy as np
    from repro_torch.launch import train
    from repro_torch.training import checkpoint as CKPT
    ckpt = ROOT / "build" / "phase9" / "danube.npz"
    argv = ["--arch", TRAIN9["arch"], "--steps", str(TRAIN9["steps"]),
            "--batch", str(TRAIN9["batch"]), "--seq", str(TRAIN9["seq"]),
            "--log-every", "1", "--ckpt", str(ckpt)]
    torch.cuda.reset_peak_memory_stats()
    undo = refuse_plain_on_cuda(torch)
    for w in wrappers.values():
        w.launches = 0
    state = {}
    t0 = time.perf_counter()
    try:
        hist = train.main(argv, state=state)
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    walls = [h["wall_s"] for h in hist]
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    cfg, lm = state["cfg"], state["lm"]
    n_attn = len(cfg.pattern) * cfg.n_groups
    t1 = time.perf_counter()
    back = CKPT.load_lm(str(ckpt), cfg, device="cuda")
    equal = all(torch.equal(a, b) for a, b in zip(
        lm.state_dict().values(), back.state_dict().values()))
    ck_bytes = ckpt.stat().st_size
    read_s = time.perf_counter() - t1
    ckpt.unlink()
    del back
    tokens = TRAIN9["batch"] * TRAIN9["seq"]
    rec = dict(arch=cfg.name, dtype=cfg.dtype, layers=n_attn,
               head_dim=cfg.head_dim, window=cfg.sliding_window,
               batch=TRAIN9["batch"], seq=TRAIN9["seq"], loss=losses,
               grad_norm=[h["grad_norm"] for h in hist], step_wall_s=walls,
               median_step_wall_s_after_first=steady,
               tokens_per_s=tokens / steady, run_wall_s=wall,
               max_memory_allocated=peak,
               launches={n: launches[n] for n in ("flash_attention",
                                                  "flash_attention_bwd")},
               other_launches={n: v for n, v in launches.items() if n not in
                               ("flash_attention", "flash_attention_bwd")},
               checkpoint_bytes=ck_bytes, checkpoint_read_s=read_s,
               checkpoint_bitwise_equal=equal)
    emit("train_attention", **rec)
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    assert launches["flash_attention"] >= 2 * n_attn * TRAIN9["steps"], \
        launches
    assert launches["flash_attention_bwd"] >= n_attn * TRAIN9["steps"], \
        launches
    assert equal, "the checkpoint read back differs from the weights"
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN9["batch"], TRAIN9["seq"] + 1))).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step_fn, opt_state = state["step_fn"], state["opt_state"]
    prof = device_profile(torch, lambda: step_fn(lm, opt_state, batch),
                          top=10, groups={"flash_fwd": "flash_fwd",
                                          "flash_bwd": "flash_bwd"})
    emit("train_attention_profile", one_step=prof)
    del lm, opt_state, batch, state
    torch.cuda.empty_cache()
    return launches


def decode_check(torch, name, depth, dtype):
    """9b's check for one model: ``dtype`` weights (seeded, on the card) at
    a capacity that drops nothing (a decode step of one token never
    drops: C >= 8 > k; the drops themselves are held against the reference
    on the CPU), `forward` over 256 tokens against 256 teacher-forced
    `decode_step`s.  Each MoE layer's routes are recorded in both paths;
    positions where they differ are counted, not compared."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe
    cfg = depth_cut(get_config(name), depth).replace(dtype=dtype)
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    routes, route = [], moe.route

    def recorded(p, c, tokens):
        out = route(p, c, tokens)
        routes.append(out[1])
        return out
    moe.route = recorded
    try:
        lm = M.init_params(cfg, seed=11, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(11)
        S = 256
        toks = torch.randint(1, cfg.vocab_size, (1, S), device="cuda",
                             generator=g)
        t0 = time.perf_counter()
        with torch.no_grad():
            full = M.forward(lm, cfg, {"tokens": toks})[0][0]
        n_moe = len(routes)
        fwd_routes = torch.stack(routes) if routes else None   # (L, S, k)
        routes.clear()
        caches = M.init_caches(cfg, 1, S, device="cuda")
        rel = []
        agree = 0
        for t in range(S):
            logits, caches = M.decode_step(lm, cfg, caches,
                                           toks[:, t:t + 1],
                                           torch.full((1,), t,
                                                      device="cuda"))
            ref = full[t]
            rel.append(torch.linalg.vector_norm(logits[0] - ref)
                       / torch.linalg.vector_norm(ref))
            agree += logits[0].argmax() == ref.argmax()
        rel = torch.stack(rel).cpu().numpy()
        same = np.ones(S, bool)
        if n_moe:
            dec = torch.stack(routes).reshape(S, n_moe, -1).transpose(0, 1)
            same = (dec == fwd_routes).all(-1).all(0).cpu().numpy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        moe.route = route
    del lm, caches, full
    torch.cuda.empty_cache()
    tol = DECODE9_TOL[dtype]
    rec = dict(check_dtype=dtype, decode_rel_l2_max=float(rel[same].max()),
               decode_rel_l2_median=float(np.median(rel[same])),
               decode_tol=tol, route_flips=int((~same).sum()),
               rel_l2_at_flips=[float(x) for x in rel[~same]],
               argmax_equal=int(agree), of=S, check_s=wall)
    assert rec["decode_rel_l2_max"] <= tol, (name, rec)
    assert rec["route_flips"] <= DECODE9_MAX_FLIPS * S, (name, rec)
    return rec


def serve_family(torch, wrappers, name, depth, check_dtype):
    """9b for one model, the counters zeroed before and read after:
    `decode_check` in ``check_dtype``, then the served model: seeded bf16
    weights on the card at the published widths (``depth`` cut) and
    capacity, `forward` over 256 tokens (MoE's dropped (token, choice)
    slots), and a `ServingEngine` serving 4 prompts x 8 tokens; the peak
    memory."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serving.engine import Request, ServingEngine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    rec = dict(arch=name, depth_cut=depth)
    rec.update(decode_check(torch, name, depth, check_dtype))
    cfg = depth_cut(get_config(name), depth)
    moe.moe_ffn.dropped = moe.moe_ffn.routed = 0
    t0 = time.perf_counter()
    lm = M.init_params(cfg, seed=11, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(12)
    toks = torch.randint(1, cfg.vocab_size, (1, 256), device="cuda",
                         generator=g)
    with torch.no_grad():
        M.forward(lm, cfg, {"tokens": toks})
    fwd_moe = (int(moe.moe_ffn.dropped), int(moe.moe_ffn.routed))
    eng = ServingEngine(cfg, lm, max_slots=4, cache_len=64, device="cuda")
    rng = np.random.default_rng(11)
    reqs = [Request(uid=i, prompt_tokens=rng.integers(
        1, cfg.vocab_size, 4 + i).astype(np.int32), max_new_tokens=8)
        for i in range(4)]
    steps = eng.run_until_drained(reqs)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    rec.update(layers=cfg.total_blocks(),
               params=sum(p.numel() for p in lm.parameters()),
               dtype=cfg.dtype, tokens=[r.output_tokens for r in reqs],
               engine_steps=steps, serve_s=time.perf_counter() - t0,
               launches={n: v for n, v in launches.items() if v},
               max_memory_allocated=torch.cuda.max_memory_allocated())
    if cfg.n_experts:
        rec.update(moe_forward_dropped=fwd_moe[0],
                   moe_forward_routed=fwd_moe[1],
                   capacity_factor=cfg.capacity_factor)
    emit("serve_family", **rec)
    kinds = [k for k, _ in cfg.pattern]
    n_gqa = sum(k in ("attn", "shared_attn") for k in kinds) * cfg.n_groups
    n_ssm = kinds.count("ssm") * cfg.n_groups + \
        [k for k, _ in cfg.tail_pattern].count("ssm") * cfg.n_tail_groups
    assert all(len(r.output_tokens) == 8 and r.error is None for r in reqs)
    # the check's and the served forward, then the decode steps
    assert launches["flash_attention"] == 2 * n_gqa, launches
    assert launches["decode_attention"] >= n_gqa * 256, launches
    assert launches["ssd_intra"] == 2 * n_ssm, launches
    del eng, lm
    torch.cuda.empty_cache()
    return rec


def phase_families(torch, smi):
    """9: the other text families on the card (slice 11), within
    `PHASE9_BUDGET_S`: a. attention training (`phase_train_attention`);
    b. each of `SERVE9` served at its published widths
    (`serve_family`), one model at a time, freed before the next.
    Returns 9a's launch counts (the path that introduced kernel 2b)."""
    wrappers = kernel_wrappers()
    t_phase = time.perf_counter()
    launches = phase_train_attention(torch, wrappers)
    t_train = time.perf_counter() - t_phase
    walls = {}
    for name, depth, check_dtype in SERVE9:
        t0 = time.perf_counter()
        serve_family(torch, wrappers, name, depth, check_dtype)
        walls[name] = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    emit("families", nvidia_smi=smi, train_wall_s=t_train,
         serve_wall_s=walls, depth_cuts={n: d for n, d, _ in SERVE9},
         phase_wall_s=wall, budget_s=PHASE9_BUDGET_S)
    assert wall < PHASE9_BUDGET_S, f"phase 9 took {wall:.1f} s"
    return launches


# ---------------------------------------------------------------------------
# phase 10: the vision and audio front ends (slice 13)
# ---------------------------------------------------------------------------

PHASE10_BUDGET_S = 120.0
#: 10a: seamless-m4t-medium at its published widths and depth, one clip
#: of 1,500 encoder rows, 256 decoder tokens, the first 32 decode steps
#: also on the recompute path
SEAMLESS10 = dict(arch="seamless-m4t-medium", frames=1500, tokens=256,
                  recompute_steps=32)
#: 10b: the reference's training split of --seq 4,096 (frames and tokens
#: seq // 2 = 2,048 each), batch 2, 10 steps, bf16, remat
TRAIN10 = dict(arch="seamless-m4t-medium", steps=10, batch=2, seq=4096)
#: 10c: internvl2-76b at 8 of its 80 layers (its f32 check takes ~36 GB:
#: 1.05 B-row embedding and head), 256 patches and 256 tokens; the kernel
#: against the plain attention at 2 layers
VLM10 = dict(arch="internvl2-76b", depth=8, check_depth=2, tokens=256)


def rel_l2(torch, a, b):
    """Relative L2 distance of each row of ``a`` from ``b`` (the last axis:
    one position's logits)."""
    return (torch.linalg.vector_norm(a - b, dim=-1)
            / torch.linalg.vector_norm(b, dim=-1))


def timed_forward(torch, fn, reps=3):
    """(result, median host wall of ``reps`` synchronized calls after a
    warm one)."""
    out = fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, sorted(walls)[reps // 2]


def seamless_decode_check(torch, wrappers):
    """10a: seamless-m4t-medium at its published widths and full depth (12
    encoder and 12 decoder layers) in f32, seeded weights and N(0, 1)
    frames (1 x 1,500 x 1,024) on the card, the counters zeroed before and
    read after: `forward` over 256 tokens against `fill_cross_cache` and
    256 teacher-forced `decode_step`s over the cached cross K / V (kernel
    3 with every slot at position 1,499), and the first 32 steps of the
    recompute path (``cross_kv_cache=False``: kernel 2 at Sq 1 from
    ``enc_out``) against the cached path's, each within
    ``DECODE9_TOL["float32"]`` (the relative L2 of a position's logits).
    Kernel 2 runs 36 times in the forward (12 encoder, 12 self, 12 cross
    layers), 12 in `encode` and 12 a recompute step; kernel 3 24 times a
    cached step and 12 a recompute step.  Then the same forward in bf16:
    its wall (median of 3 after a warm call) and peak memory."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    n = SEAMLESS10
    cfg = get_config(n["arch"]).replace(dtype="float32")
    S, Se, R = n["tokens"], n["frames"], n["recompute_steps"]
    L, E = cfg.total_blocks(), cfg.encoder_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    lm = M.init_params(cfg, seed=13, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(13)
    frames = torch.randn(1, Se, cfg.frontend_dim, device="cuda",
                         generator=g)
    toks = torch.randint(1, cfg.vocab_size, (1, S), device="cuda",
                         generator=g)
    with torch.no_grad():
        full = M.forward(lm, cfg, {"tokens": toks, "frames": frames})[0][0]
        enc = M.encode(lm, cfg, frames)
    caches = M.fill_cross_cache(lm, cfg, M.init_caches(
        cfg, 1, S, device="cuda", enc_len=Se), enc)
    steps = []
    for t in range(S):
        logits, caches = M.decode_step(lm, cfg, caches, toks[:, t:t + 1],
                                       torch.full((1,), t, device="cuda"))
        steps.append(logits[0])
    steps = torch.stack(steps)
    rcfg = cfg.replace(cross_kv_cache=False)
    rcaches = M.init_caches(rcfg, 1, S, device="cuda", enc_len=Se)
    recomputed = []
    for t in range(R):
        logits, rcaches = M.decode_step(lm, rcfg, rcaches, toks[:, t:t + 1],
                                        torch.full((1,), t, device="cuda"),
                                        enc_out=enc)
        recomputed.append(logits[0])
    dec_rel = rel_l2(torch, steps, full).cpu().numpy()
    re_rel = rel_l2(torch, torch.stack(recomputed), steps[:R]).cpu().numpy()
    agree = int((steps.argmax(-1) == full.argmax(-1)).sum())
    check_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    peak_f32 = torch.cuda.max_memory_allocated()
    del lm, caches, rcaches, full, enc, steps, recomputed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bcfg = get_config(n["arch"])
    lm = M.init_params(bcfg, seed=13, device="cuda")
    for w in wrappers.values():
        w.launches = 0

    def fwd():
        with torch.no_grad():
            return M.forward(lm, bcfg, {"tokens": toks, "frames": frames})[0]
    out, bf16_wall = timed_forward(torch, fwd)
    bf16_launches = wrappers["flash_attention"].launches
    finite = bool(torch.isfinite(out).all())
    tol = DECODE9_TOL["float32"]
    rec = dict(arch=n["arch"], encoder_layers=E, decoder_layers=L,
               frames=Se, tokens=S, check_dtype="float32",
               decode_rel_l2_max=float(dec_rel.max()),
               decode_rel_l2_median=float(np.median(dec_rel)),
               argmax_equal=agree, of=S, recompute_steps=R,
               recompute_rel_l2_max=float(re_rel.max()), decode_tol=tol,
               launches=launches, check_s=check_s,
               max_memory_allocated_f32=peak_f32,
               bf16_forward_wall_s=bf16_wall,
               bf16_forward_launches=bf16_launches,
               bf16_max_memory_allocated=torch.cuda.max_memory_allocated(),
               bf16_logits_finite=finite)
    emit("front_end_seamless", **rec)
    del lm, out
    torch.cuda.empty_cache()
    assert rec["decode_rel_l2_max"] <= tol, rec
    assert rec["recompute_rel_l2_max"] <= tol, rec
    assert finite, rec
    assert launches.get("flash_attention") == 2 * (E + L) + R * L, launches
    assert launches.get("decode_attention") == 2 * L * S + L * R, launches
    assert bf16_launches == 4 * (E + 2 * L), bf16_launches


def seamless_train(torch, wrappers):
    """10b: seamless-m4t-medium at its published widths and depth trains
    10 steps of `make_train_step` in bf16 with per-layer remat, batch 2 x
    (2,048 frames + 2,048 tokens): the reference's training split of
    ``--seq`` 4,096 on the zipf stream, with seeded N(0, 1) frames (the
    CLI's zero frames give a zero encoder output and zero gradients to
    every encoder and cross-attention weight),
    under `refuse_plain_on_cuda`, the counters zeroed just before and
    read just after.  The loss must stay finite and fall; kernel 2 runs
    twice a step in each of the 36 attention layers (12 encoder, 12 self,
    12 cross; the forward and the remat's recompute), 720 in all, and
    kernel 2b once, 360.  Then one more step under `torch.profiler`, and
    `launch.train.main --arch seamless-m4t-medium --steps 2 --ckpt` (the
    CLI's batch: zero frames), its checkpoint read back bitwise through
    `checkpoint.load_lm`."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import DataConfig, SyntheticLMStream
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step
    n = TRAIN10
    cfg = get_config(n["arch"])
    half, B = n["seq"] // 2, n["batch"]
    n_attn = cfg.encoder_layers + 2 * cfg.total_blocks()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = M.init_params(cfg, seed=14, device="cuda")
    opt_state = O.init(dict(lm.named_parameters()))
    step_fn = make_train_step(cfg, O.OptConfig(
        lr=1e-3, warmup_steps=max(n["steps"] // 10, 1),
        total_steps=n["steps"]))
    stream = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=n["seq"], global_batch=B,
        seed=0))
    g = torch.Generator(device="cuda").manual_seed(14)

    def batch_of(step):
        b = {k: torch.from_numpy(np.ascontiguousarray(v[:, :half])).cuda()
             for k, v in stream.batch(step).items()}
        b["frames"] = torch.randn(B, half, cfg.frontend_dim, device="cuda",
                                  generator=g)
        return b
    undo = refuse_plain_on_cuda(torch)
    for w in wrappers.values():
        w.launches = 0
    hist = []
    t0 = time.perf_counter()
    try:
        for step in range(n["steps"]):
            batch = batch_of(step)
            t1 = time.perf_counter()
            met = step_fn(lm, opt_state, batch)
            torch.cuda.synchronize()
            hist.append(dict(loss=float(met["loss"]),
                             grad_norm=float(met["grad_norm"]),
                             wall_s=time.perf_counter() - t1))
    finally:
        undo()
    run_wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    walls = [h["wall_s"] for h in hist]
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    prof = device_profile(torch, lambda: step_fn(lm, opt_state, batch),
                          top=10, groups={"flash_fwd": "flash_fwd",
                                          "flash_bwd": "flash_bwd"})
    del lm, opt_state, batch, step_fn
    torch.cuda.empty_cache()
    ckpt = ROOT / "build" / "phase10" / "seamless.npz"
    state = {}
    t1 = time.perf_counter()
    cli = train.main(["--arch", n["arch"], "--steps", "2", "--log-every",
                      "1", "--ckpt", str(ckpt)], state=state)
    cli_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    back = CKPT.load_lm(str(ckpt), state["cfg"], device="cuda")
    equal = all(torch.equal(a, b) for a, b in zip(
        state["lm"].state_dict().values(), back.state_dict().values()))
    read_s = time.perf_counter() - t1
    ck_bytes = ckpt.stat().st_size
    ckpt.unlink()
    del back, state
    torch.cuda.empty_cache()
    tokens = B * half
    rec = dict(arch=n["arch"], dtype=cfg.dtype, remat=cfg.remat,
               attention_layers=n_attn, batch=B, frames=half, tokens=half,
               loss=losses, grad_norm=[h["grad_norm"] for h in hist],
               step_wall_s=walls, median_step_wall_s_after_first=steady,
               tokens_per_s=tokens / steady,
               frames_and_tokens_per_s=2 * tokens / steady,
               run_wall_s=run_wall, max_memory_allocated=peak,
               launches={k: launches[k] for k in ("flash_attention",
                                                   "flash_attention_bwd")},
               other_launches={k: v for k, v in launches.items() if v and k
                               not in ("flash_attention",
                                       "flash_attention_bwd")},
               profiled_step=prof, cli_losses=[h["loss"] for h in cli],
               cli_s=cli_s, checkpoint_bytes=ck_bytes,
               checkpoint_read_s=read_s, checkpoint_bitwise_equal=equal)
    emit("front_end_train", **rec)
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    assert launches["flash_attention"] == 2 * n_attn * n["steps"], launches
    assert launches["flash_attention_bwd"] == n_attn * n["steps"], launches
    assert all(np.isfinite([h["loss"] for h in cli])), cli
    assert equal, "the checkpoint read back differs from the weights"


def vlm_front_end(torch, wrappers):
    """10c: internvl2-76b at its published widths, 8 of 80 layers
    (`depth_cut`), served as `serve_family` serves a SERVE9 model (the
    text-only forward against 256 teacher-forced decode steps in f32, then
    bf16 weights serving 4 prompts x 8 tokens: the reference's engine takes
    no patches); then, the counters zeroed, a bf16 forward over 256 seeded
    N(0, 1) patches (3,200 wide) ahead of 256 tokens (wall, median of 3
    after a warm call; peak memory; kernel 2 once a layer and call); and
    the same patch-prefixed forward at 2 of 80 layers in f32 held against
    the same weights through the plain attention on the card, each of the
    512 positions' logits within ``DECODE9_TOL["float32"]``: the one
    deliberate use of the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_reference)
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    n = VLM10
    serve_family(torch, wrappers, n["arch"], n["depth"], "float32")
    cfg = depth_cut(get_config(n["arch"]), n["depth"])
    P, S = cfg.num_patches, n["tokens"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    lm = M.init_params(cfg, seed=15, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(15)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (1, S),
                                     device="cuda", generator=g),
             "patches": torch.randn(1, P, cfg.frontend_dim, device="cuda",
                                    generator=g)}

    def fwd(lm_, cfg_):
        with torch.no_grad():
            return M.forward(lm_, cfg_, batch)[0][0]
    out, wall = timed_forward(torch, lambda: fwd(lm, cfg))
    rec = dict(arch=n["arch"], depth_cut=n["depth"], patches=P, tokens=S,
               frontend_dim=cfg.frontend_dim,
               bf16_forward_wall_s=wall,
               bf16_forward_launches=wrappers["flash_attention"].launches,
               bf16_max_memory_allocated=torch.cuda.max_memory_allocated(),
               bf16_logits_shape=list(out.shape),
               bf16_logits_finite=bool(torch.isfinite(out).all()))
    del lm, out
    torch.cuda.empty_cache()
    ccfg = depth_cut(get_config(n["arch"]), n["check_depth"]).replace(
        dtype="float32")
    lm = M.init_params(ccfg, seed=15, device="cuda")
    got = fwd(lm, ccfg)
    kernel = A.flash_attention
    A.flash_attention = lambda q, k, v, *, causal, window: \
        flash_attention_reference(q, k, v, causal=causal, window=window)
    try:
        want = fwd(lm, ccfg)
    finally:
        A.flash_attention = kernel
    rel = rel_l2(torch, got, want).cpu().numpy()
    tol = DECODE9_TOL["float32"]
    rec.update(plain_check_depth=n["check_depth"], plain_check_positions=
               len(rel), plain_rel_l2_max=float(rel.max()),
               plain_rel_l2_patch_max=float(rel[:P].max()),
               plain_check_tol=tol)
    emit("front_end_vlm", **rec)
    del lm, got, want
    torch.cuda.empty_cache()
    assert rec["bf16_logits_finite"], rec
    assert rec["bf16_logits_shape"] == [P + S, cfg.vocab_size], rec
    assert rec["bf16_forward_launches"] == 4 * cfg.total_blocks(), rec
    assert rec["plain_rel_l2_max"] <= tol, rec


def phase_front_ends(torch, smi):
    """10: the vision and audio front ends on the card (slice 13), within
    `PHASE10_BUDGET_S`: a. seamless-m4t-medium's forward against its
    cached and recomputed cross decode (`seamless_decode_check`); b.
    seamless trains (`seamless_train`); c. internvl2-76b served and its
    patch prefix (`vlm_front_end`)."""
    wrappers = kernel_wrappers()
    t_phase = time.perf_counter()
    walls = {}
    for part, fn in (("a", seamless_decode_check), ("b", seamless_train),
                     ("c", vlm_front_end)):
        t0 = time.perf_counter()
        fn(torch, wrappers)
        walls[part] = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    emit("front_ends", nvidia_smi=smi, part_wall_s=walls,
         depth_cuts={SEAMLESS10["arch"]: None, VLM10["arch"]: VLM10["depth"]},
         phase_wall_s=wall, budget_s=PHASE10_BUDGET_S)
    assert wall < PHASE10_BUDGET_S, f"phase 10 took {wall:.1f} s"


# ---------------------------------------------------------------------------
# phase 11: the tooling on the card (slice 14)
# ---------------------------------------------------------------------------

PHASE11_BUDGET_S = 60.0


def tooling_context(ctx):
    """What phase 11 keeps of phase 4's context when the engines are freed:
    the encoder, the texts and lambdas, the support's train rows and the
    three routers (`knn10`, phase 4b's `knn100-ivf`, which phase 7 streamed
    into, and the artifact-booted `knn100-ivfpq`)."""
    return dict(encoder=ctx["encoder"], texts=ctx["texts"],
                lams=ctx["lams"], support=ctx["ds"].part("train")[0],
                names=list(ctx["knn10_svc"].model_names),
                routers={"knn10": ctx["knn10_svc"].router,
                         "knn100-ivf": ctx["ivf_svc"].router,
                         "knn100-ivfpq": ctx["ivfpq_svc"].router})


def quiet_threads(wait_s=5.0):
    """The threads other than this one still alive after waiting up to
    ``wait_s`` for them: `set_sync_debug_mode` is process-wide, so phase
    11's counts hold only with none."""
    import threading
    deadline = time.perf_counter() + wait_s
    for t in threading.enumerate():
        if t is not threading.current_thread():
            t.join(max(0.0, deadline - time.perf_counter()))
    return [t.name for t in threading.enumerate()
            if t is not threading.current_thread() and t.is_alive()]


def phase_tooling(torch, tctx):
    """11: the port's tooling on the card, within `PHASE11_BUDGET_S`.
    a. `repro_torch.analysis.lint` over src/repro_torch: 0 findings, an
       empty baseline.  b. `route_fused` of the 16 texts on `knn10`,
       `knn100-ivf` and `knn100-ivfpq` under `SyncCounter` (no other
       thread alive): the syncs by `path:line`, every one on an allow-host
       line; then five more waves of each under `CacheCounter`: no cache
       grows.  c. `autotune_router` on the two IVF routers at Q 16 (the
       served texts) and 64 (their request template over 64 texts): kernel
       4 alone at block_q 8 / 16 / 32 / 64 (every candidate's neighbours
       bitwise equal, asserted by the sweep), kernel 5's one search timed
       once; each candidate's p50 and roofline terms; Q 16's choice put
       into a `DispatchPolicy`, saved with the artifact, loaded back and
       routed again: equal decisions, the chosen tile launched, kernel 5
       on its fused launch.  d.
       `autotune_lane_pad` (8, 128) on 20,000 rows of the support."""
    import numpy as np
    from repro_torch.analysis.core import load_baseline
    from repro_torch.analysis.lint import (DEFAULT_BASELINE, build_project,
                                           lint_tree)
    from repro_torch.analysis.sanitizers import (CacheCounter, SyncCounter,
                                                 allowed_by_pragma,
                                                 port_caches)
    from repro_torch.core.routers.artifacts import load_router, save_router
    from repro_torch.core.routers.dispatch import DispatchPolicy
    from repro_torch.kernels.knn_ivf import autotune as at
    from repro_torch.kernels.knn_ivf import ops as ivf_ops
    from repro_torch.launch.serve import TOPICS
    from repro_torch.serving.router_service import RouterService

    t_phase = time.perf_counter()
    walls = {}
    # a. the lint
    t0 = time.perf_counter()
    project = build_project(ROOT / "src" / "repro_torch")
    active, baselined = lint_tree(project,
                                  config={"baseline": str(DEFAULT_BASELINE)})
    walls["a_lint_s"] = time.perf_counter() - t0
    emit("tooling_lint", files=len(project.modules),
         findings=[f.render() for f in active], baselined=len(baselined),
         baseline_keys=len(load_baseline(DEFAULT_BASELINE)),
         wall_s=walls["a_lint_s"])
    assert not active and not baselined, [f.render() for f in active]
    assert load_baseline(DEFAULT_BASELINE) == set()

    # b. the syncs of each route, then five waves under the cache counter
    t0 = time.perf_counter()
    encoder, texts, lams = tctx["encoder"], tctx["texts"], tctx["lams"]
    emb = encoder.embed_texts(texts)
    svcs = {n: RouterService(r, {m: None for m in tctx["names"]},
                             encoder=encoder)
            for n, r in tctx["routers"].items()}
    alive = quiet_threads()
    assert not alive, f"threads alive under the sync counter: {alive}"
    first, syncs = {}, {}
    for name, svc in svcs.items():
        first[name] = svc.route_fused(emb, lams)     # caches warm
        torch.cuda.synchronize()
        with SyncCounter() as sc:
            out = svc.route_fused(emb, lams)
        bad = allowed_by_pragma(sc.records)
        syncs[name] = sc.by_site()
        assert sc.records, f"{name}: no sync recorded (the end-of-batch " \
            f"copy must show)"
        assert not bad, (name, [r.site for r in bad])
        for a, b in zip(out, first[name]):
            np.testing.assert_array_equal(a, b)
    cc = CacheCounter(port_caches(tctx["routers"]))
    sizes = cc.snapshot()
    for _ in range(5):
        for svc in svcs.values():
            svc.route_fused(emb, lams)
    growth = cc.growth()
    walls["b_syncs_caches_s"] = time.perf_counter() - t0
    emit("tooling_syncs", texts=16, syncs_by_site=syncs,
         syncs_per_route={n: sum(v.values()) for n, v in syncs.items()},
         all_on_allow_host_lines=True, cache_sizes=sizes,
         cache_growth_over_5_waves=growth, wall_s=walls["b_syncs_caches_s"])
    assert growth == {}, growth

    # c. the autotuner on the two IVF routers, then the tuned round trip
    t0 = time.perf_counter()
    texts64 = [f"{TOPICS[i % len(TOPICS)]} request number {i}"
               for i in range(64)]
    emb64 = encoder.embed_texts(texts64)
    tuned = {}
    for name in ("knn100-ivf", "knn100-ivfpq"):
        r = tctx["routers"][name]
        for Q, e in ((16, emb), (64, emb64)):
            res = at.autotune_router(r, e, repeats=5,
                                     block_qs=ivf_ops.IVF_BLOCK_QS,
                                     probe_chunks=(0, 2))
            emit("tooling_autotune", router=name, Q=Q, chosen={
                k: v for k, v in res.items() if k != "sweep"},
                sweep=res["sweep"], neighbours_bitwise_equal=True)
            tuned.setdefault(name, res)
    rt = {}
    for name, res in tuned.items():
        r = tctx["routers"][name]
        tiles = {k: v for k, v in res.items() if k != "sweep"}
        saved = r.dispatch_policy
        r.dispatch_policy = DispatchPolicy(cells={}, tiles={r.index: tiles})
        try:
            path = save_router(r, ROOT / "build" / "chip_smoke" /
                               f"tuned-{name}")
        finally:
            r.dispatch_policy = saved
        r2 = load_router(path, device="cuda")
        assert r2.dispatch_policy.tiles_for(r2.index) == tiles
        out = RouterService(r2, {m: None for m in tctx["names"]},
                            encoder=encoder).route_fused(emb, lams)
        for a, b in zip(out, first[name]):
            np.testing.assert_array_equal(a, b)
        if r2.index == "ivf":
            assert ivf_ops.ivf_scan.last_block_q == tiles["block_q"], \
                (ivf_ops.ivf_scan.last_block_q, tiles)
            launched = {"block_q": ivf_ops.ivf_scan.last_block_q}
        else:       # kernel 5's shape keeps its fused launch (kk 800)
            assert ivf_ops.ivfpq_adc.last_cuda_launches == 1, tiles
            launched = {"kernel5_cuda_launches":
                        ivf_ops.ivfpq_adc.last_cuda_launches}
        rt[name] = dict(tiles=tiles, launched=launched,
                        decisions_equal=True)
        del r2
    walls["c_autotune_s"] = time.perf_counter() - t0
    emit("tooling_roundtrip", routers=rt, wall_s=walls["c_autotune_s"])

    # d. the builder's list padding on a subsample
    t0 = time.perf_counter()
    lp = at.autotune_lane_pad(tctx["support"], emb, 100, pq=False,
                              candidates=(8, 128), sample=20_000,
                              device="cuda", repeats=5)
    walls["d_lane_pad_s"] = time.perf_counter() - t0
    emit("tooling_lane_pad", rows=20_000, result=lp,
         wall_s=walls["d_lane_pad_s"])
    wall = time.perf_counter() - t_phase
    emit("tooling", phase_wall_s=wall, budget_s=PHASE11_BUDGET_S,
         parts_s=walls)
    assert wall < PHASE11_BUDGET_S, f"phase 11 took {wall:.1f} s"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 3's random inputs (default 0)")
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
    from repro_torch.launch.mesh import CARD, POWER_LIMIT
    # every bound_ms divides by CARD's peaks: say whether they are this
    # card's (a lower power limit makes the bounds optimistic)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         tf32="off for matmul and cudnn",
         bound_peaks_of=f"{CARD}, {POWER_LIMIT}",
         bound_peaks_are_this_cards=smi == f"{CARD}, {POWER_LIMIT}")

    report = _build.build_all()
    emit("build", seconds=report.pop("total_s"), ptxas=report)
    # the SSD kernels' products must run on the tensor cores
    hmma = {n: _build.sass_count(n, "HMMA") for n in ("ssd_intra",
                                                      "ssd_intra_bwd")}
    # and so must kernel 2b's dQ and dK / dV passes (one kernel,
    # flash_bwd_kernel), bf16 (HMMA.16816) and f32 (three TF32 passes,
    # HMMA.1688), at each head dim
    bwd = {op: {f: n for f, n in _build.sass_count(
                "flash_attention_bwd", op, by_function=True).items()
                if "flash_bwd_kernel" in f}
           for op in ("HMMA.16816", "HMMA.1688")}
    emit("build_sass", hmma_instructions=hmma,
         flash_attention_bwd_hmma=bwd)
    assert all(v > 0 for v in hmma.values()), hmma
    for op, tag in (("HMMA.16816", "__nv_bfloat16"), ("HMMA.1688", "IfLi")):
        # the 4 head dims of the one dtype (<float, 64> mangles as
        # ...IfLi64E...)
        got = [f for f, n in bwd[op].items() if n > 0]
        assert len(got) == 4 and all(tag in f for f in got), (op, bwd[op])

    main_cases = phase_kernels(torch, args.seed)
    launches = {n: None for n in main_cases}
    if not args.kernels:
        # each kernel's launches are read on the path that introduced it
        first, ctx = phase_main_path(torch)
        second, real = phase_ivf_path(torch, ctx)
        main_cases.update(real)
        third = phase_train(torch)
        phase_forward_decode(torch)
        phase_mamba_serving(torch, ctx)
        phase_gateway(torch, ctx, smi)
        phase_streaming(torch, ctx, smi)
        # phases 8 and 9 use none of phase 4's engines and services (~16
        # GB): free them before 9's models, which take up to 59 GB; phase
        # 11 keeps the encoder and the routers
        tctx = tooling_context(ctx)
        ctx.clear()
        gc.collect()
        torch.cuda.empty_cache()
        phase_evaluation(torch, smi)
        ninth = phase_families(torch, smi)
        phase_front_ends(torch, smi)
        phase_tooling(torch, tctx)
        path_of = {"ivf_topk": second, "ivfpq_adc": second,
                   "ssd_intra": third, "ssd_intra_bwd": third,
                   "flash_attention_bwd": ninth}
        launches = {n: path_of.get(n, first)[n] for n in main_cases}
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
