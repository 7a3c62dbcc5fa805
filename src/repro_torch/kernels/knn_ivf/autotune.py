"""Measured autotuning of the retrieval kernels' own tiles (the port of
`repro.kernels.knn_ivf.autotune`, same functions and return shapes).

The kernels ship hand-picked defaults — kernel 4's query tile chosen from
the batch (`ops.block_q_for`: 16, 64 from Q 64), kernel 5's fused
one-launch path wherever the shape fits it, ``lane_pad=8`` list padding in
the builders.  This module measures the candidates on the caller's real
index and query shapes, and records roofline terms (bytes and operations
reckoned from the kernel's shapes, over `repro_torch.launch.mesh`'s HBM
rate and f32 peak) alongside, so a reader can see WHY a candidate won
without re-running the sweep.  The measured time decides; the roofline
terms are the explanation.  Every candidate must return the same bits as
the first: the tiles change times, never neighbours (the sweep asserts
it).

The chosen constants ride in `DispatchPolicy.tiles` (per index kind), are
persisted with the router artifact, and are consumed by `KNNRouter._search`
(``block_q``) and `KNNRouter._index_build_kw` (``lane_pad`` — so streaming
re-clusters rebuild with the tuned padding).

Tuned knobs (the reference's names, the CUDA kernels' meanings):

  * ``block_q``     kernel 4's query tile (`kernel.cu`, instantiated at 8,
                    16, 32 and 64): the queries whose blocks share each read
                    of a probed list.  Taller tiles read a list shared by
                    many queries fewer times; shorter ones keep more blocks
                    busy.  Timed on kernel 4 alone, the probe made once.
  * ``probe_chunk`` no knob of the port: kernel 5's shape picks its path
                    (`ops.fused_fits`).  Kernel 5 has no query tile either,
                    so on an IVF-PQ index the search is timed once, every
                    ``block_q`` / ``probe_chunk`` candidate carries that one
                    measurement, and the chosen values are the defaults (16
                    and 0, else the first candidate): the reference's dict
                    shape, and an artifact the reference loads.
  * ``lane_pad``    builder list padding: measured on a subsampled build
                    per candidate because a full re-build per candidate
                    would cost a k-means each.

On the card a time is device time: CUDA events around ``iters`` calls
queued behind a short device spin, so the host's launch overhead is not
timed (a call that waits on the card inside counts its host gaps).  On the
CPU it is the wall time of the plain versions, which ignore ``block_q``;
the sweep still returns the reference's dict shape.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_F32
from . import ops
from .ref import ivf_probe

#: device cycles spun before each timed run (~5 ms on an H100), long
#: enough for the host to queue the run's calls behind it
_SPIN_CYCLES = 10_000_000


def _p50(fn: Callable, repeats: int, device, iters: int = 10) -> float:
    """Median over ``repeats`` runs of the seconds a call of ``fn`` takes:
    on the card, CUDA events around ``iters`` calls queued behind a device
    spin; on the CPU, the wall time of one call.  One warm-up call
    first."""
    fn()
    if torch.device(device).type != "cuda":
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.percentile(times, 50))
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize(device)
        torch.cuda._sleep(_SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3 / iters)
    return float(np.percentile(times, 50))


def roofline_terms(index, queries, k: int, *, nprobe: int,
                   rerank: int = 0,
                   block_q: Optional[int] = None) -> Dict[str, float]:
    """Bytes and operations of one search over a frozen ``index``, reckoned
    from the kernel's shapes as `chip_smoke.bound` does (there is no HLO to
    read here), and the least time each implies on the card.  Kernel 4
    (`IVFIndex`): the queries and probe ids, each probed list's rows, ids
    and inverse norms read once per tile of ``block_q`` queries that
    probes it (None: `ops.block_q_for` Q), the (Q, k) scores and ids
    written, 2 Q P L D operations.  Kernel 5 (`IVFPQIndex`): the queries,
    the codebooks, each probed list's codes, ids, inverse norms and anchor
    once, the shortlist written, the ADC table and keys' round trip
    through HBM where the shape takes the three launches, then the
    re-rank's gathered rows; operations of the table, the code sums and
    the re-rank's dots.  The probe (Q x C dots over the centroids) is
    counted in both."""
    q = ops._queries(queries, index)
    Q, D = q.shape
    C, L = index.n_clusters, index.list_size
    P = max(1, min(nprobe, C))
    probe = ivf_probe(q, index.centroids, P).cpu().numpy()
    nbytes = Q * D * 4 + C * D * 4 + Q * P * 4
    flops = 2 * Q * C * D
    if isinstance(index, ops.IVFPQIndex):
        kc = min(k, index.n_rows, P * L)
        kk = min(max(rerank, 1) * kc, index.n_rows, P * L) if rerank else kc
        m, K = index.m, 2 ** index.nbits
        MB = index.codes_cm.shape[1]
        lists = len(np.unique(probe))
        nbytes += m * K * (D // m) * 4 + lists * (MB * L + L * 8 + D * 4) \
            + Q * kk * 8
        flops += 2 * Q * K * D + Q * P * L * (m + 2) + 2 * Q * P * D
        if not ops.fused_fits(m, index.nbits, MB, L, P, kk, 0):
            nbytes += 2 * (Q * m * K * 4 + Q * P * L * 8)
        if rerank:
            nbytes += Q * kk * (D * 4 + 8) + Q * kc * 8
            flops += 2 * Q * kk * D
    else:
        bq = ops.check_block_q(block_q) or ops.block_q_for(Q)
        kc = min(k, index.n_rows, P * L)
        reads = sum(len(np.unique(probe[t:t + bq]))
                    for t in range(0, Q, bq))
        nbytes += reads * L * (D * 4 + 8) + Q * kc * 8
        flops += 2 * Q * P * L * D
    t_c = flops / PEAK_FLOPS_F32
    t_m = nbytes / HBM_BW
    return {"flops": float(flops), "bytes": float(nbytes),
            "t_compute_s": t_c, "t_memory_s": t_m,
            "bound": "memory" if t_m >= t_c else "compute"}


def _search(index, queries, k: int, nprobe: int, rerank: int, **knob):
    if isinstance(index, ops.IVFPQIndex):
        return lambda: ops.ivfpq_topk(queries, index, k, nprobe=nprobe,
                                      rerank=rerank, **knob)
    return lambda: ops.ivf_topk(queries, index, k, nprobe=nprobe, **knob)


def _kernel4(index, q, k: int, nprobe: int, block_q: int):
    """Kernel 4 alone over a frozen `IVFIndex` at one query tile, the
    probe made once outside the timed call (k clamped as `ivf_topk`)."""
    P = max(1, min(nprobe, index.n_clusters))
    kc = min(k, index.n_rows, P * index.list_size)
    probe = ivf_probe(q, index.centroids, P)
    return lambda: ops.ivf_scan(q, probe, index.sup_cm, index.ids_cm,
                                index.inv_cm, kc, block_q=block_q)


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _terms(terms: dict) -> dict:
    return {k: (round(v, 9) if isinstance(v, float) else v)
            for k, v in terms.items()}


def _sweep(make_candidate, candidates: Sequence[int], repeats: int,
           device) -> dict:
    """Time each candidate (``make_candidate(c)`` -> (callable, roofline
    terms)); every candidate's output must equal the first's bitwise."""
    detail, first = {}, None
    for c in candidates:
        run, terms = make_candidate(c)
        out = run()
        if first is None:
            first = out
        elif not _same_bits(first, out):
            raise AssertionError(f"tile candidate {c} returned other "
                                 f"neighbours than {candidates[0]}")
        detail[int(c)] = {"p50_s": round(_p50(run, repeats, device), 9),
                          **_terms(terms)}
    best = min(detail, key=lambda c: detail[c]["p50_s"])
    return {"chosen": int(best), "candidates": detail}


def _default(candidates: Sequence[int], value: int) -> int:
    return int(value) if value in candidates else int(candidates[0])


def autotune_tiles(index, queries, k: int, *,
                   nprobe: int = ops.DEFAULT_NPROBE,
                   rerank: int = ops.DEFAULT_RERANK,
                   block_qs: Sequence[int] = ops.IVF_BLOCK_QS,
                   probe_chunks: Sequence[int] = (0, 2, 4),
                   repeats: int = 5) -> dict:
    """Tune the per-index-kind kernel constants on a real (index, queries)
    pair.  Returns ``{"block_q": .., "probe_chunk": .., "sweep": {...}}``
    (``probe_chunk`` for IVF-PQ only) — the flat chosen values feed
    `DispatchPolicy.tiles`, the ``sweep`` detail (per-candidate p50 +
    roofline terms) goes to the caller's report.  A streaming index is
    tuned on its base.  On IVF-PQ nothing is swept: the one search's time
    stands for every candidate (see the module's docstring)."""
    if isinstance(index, ops.DynamicIVFIndex):
        index = index.fused_state().base
    q = ops._queries(queries, index)
    for b in block_qs:
        ops.check_block_q(b)
    dev = index.device
    out: Dict = {"sweep": {}}
    if not isinstance(index, ops.IVFPQIndex):
        bq = _sweep(lambda c: (
            _kernel4(index, q, k, nprobe, c),
            roofline_terms(index, q, k, nprobe=nprobe, block_q=c)),
            block_qs, repeats, dev)
        out["block_q"] = bq["chosen"]
        out["sweep"]["block_q"] = bq["candidates"]
        return out
    one = {"p50_s": round(_p50(_search(index, q, k, nprobe, rerank),
                               repeats, dev), 9),
           **_terms(roofline_terms(index, q, k, nprobe=nprobe,
                                   rerank=rerank))}
    pcs = [p for p in probe_chunks if p == 0 or p < nprobe]
    out["block_q"] = _default(block_qs, ops.DEFAULT_BLOCK_Q)
    out["sweep"]["block_q"] = {int(c): dict(one) for c in block_qs}
    out["probe_chunk"] = _default(pcs, 0)
    out["sweep"]["probe_chunk"] = {int(c): dict(one) for c in pcs}
    return out


def autotune_lane_pad(support, queries, k: int, *, pq: bool,
                      m: Optional[int] = None, nbits: int = 8,
                      nprobe: int = ops.DEFAULT_NPROBE,
                      rerank: int = ops.DEFAULT_RERANK,
                      candidates: Sequence[int] = (8, 128),
                      sample: int = 20_000, seed: int = 0,
                      repeats: int = 3, device="cuda") -> dict:
    """Tune the builder's list padding by building each candidate on a
    subsample of ``support`` on ``device`` (a full-corpus build per
    candidate would pay a k-means each) and timing the search over it.
    The winner feeds `DispatchPolicy.tiles[index]["lane_pad"]`, which
    `KNNRouter._index_build_kw` replays into streaming re-clusters."""
    sup = np.asarray(support, np.float32)[:sample]
    detail = {}
    for lp in candidates:
        if pq:
            idx = ops.build_ivfpq_index(sup, m=m, nbits=nbits, seed=seed,
                                        lane_pad=lp, device=device)
        else:
            idx = ops.build_ivf_index(sup, seed=seed, lane_pad=lp,
                                      device=device)
        run = _search(idx, ops._queries(queries, idx), k, nprobe, rerank,
                      backend="fused")
        detail[int(lp)] = {"p50_s": round(_p50(run, repeats, device), 9),
                           "list_size": int(idx.list_size)}
    best = min(detail, key=lambda c: detail[c]["p50_s"])
    return {"chosen": int(best), "candidates": detail}


def autotune_router(router, queries, *, repeats: int = 5,
                    block_qs: Sequence[int] = ops.IVF_BLOCK_QS,
                    probe_chunks: Sequence[int] = (0, 2, 4)) -> dict:
    """`autotune_tiles` over a fitted `KNNRouter`'s own index and operating
    point (k / nprobe / rerank), queries L2-normalized the way the serving
    path would.  Returns ``{}`` for ``index="exact"`` (no tiles)."""
    if getattr(router, "index", "exact") == "exact":
        return {}
    q = np.asarray(queries, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    return autotune_tiles(router._ivf, q, router.k, nprobe=router.nprobe,
                          rerank=router.rerank, block_qs=block_qs,
                          probe_chunks=probe_chunks, repeats=repeats)
