"""Plain-torch IVF retrieval: the coarse probe, the two oracles of
`repro.kernels.knn_ivf.ref`, and the plain versions of the two CUDA
kernels.

Semantics (shared with `kernel.cu` / `pq_kernel.cu`):

  * a spherical k-means coarse quantizer partitions the support set into C
    lists, stored cluster-major as ``sup_cm (C, L, D)`` (raw rows, zero
    padding) with original row ids in ``ids_cm (C, L)`` (-1 padding) and
    exact inverse row norms in ``inv_cm (C, L)`` (0 padding);
  * each query probes its ``nprobe`` nearest centroids and scores ONLY
    those lists; ``nprobe == C`` recovers the brute-force result.

Empty output slots (fewer than k valid candidates) carry score -inf and
index -1, and a masked candidate never leaks its row id.

``ivf_scan_plain`` / ``ivfpq_adc_plain`` take the probe set as an input,
as the kernels do: per query, over the rows of its own probed lists,
``(q . row) * inv`` (raw) or ``(sum_j LUT[j, code_j] + q . anchor) * inv``
(ADC), masked to ``ids >= 0``, then top-k.  The oracles
(``ivf_topk_reference``, normalizing rows on the fly, and the decode-based
``ivfpq_adc_reference``) share no scoring code with them.

A streaming index adds its delta tier (`DeltaLists`): each probed slot
also scores the rows of its centroid's delta sub-list, with the same
formula (over a PQ base the delta rows are coded against the anchor of
their own centroid), and base and delta candidates go into ONE top-k —
what the reference's ``_fused_dyn_ivf_topk_impl`` /
``_fused_dyn_ivfpq_topk_impl`` compute over their padded ``(C, Lc)``
sub-lists.  Delta row ``j`` carries the global id ``n_base + j``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .pq import unpack_codes_cm


class DeltaLists(NamedTuple):
    """A streaming index's delta tier as kernels 4 and 5 read it: the rows
    once, in append order, grouped by assigned centroid through ``off`` /
    ``perm`` (CSR): sub-list ``c`` is rows ``perm[off[c]:off[c + 1]]``, in
    append order.  The reference pads the sub-lists to ``(C, Lc, D)``;
    this holds the same candidates in ``nd x D``."""
    rows: torch.Tensor       # (nd, D) f32 raw rows, append order
    inv: torch.Tensor        # (nd,) f32 exact 1 / ||row||
    codes: Optional[torch.Tensor]  # (MB, >= nd) u8 code-major, column j =
                                   # row j's residual codes (PQ), else None
    off: torch.Tensor        # (C + 1,) int32 sub-list offsets into perm
    perm: torch.Tensor       # (nd,) int32 row numbers, by centroid
    n_base: int              # global id of delta row j: n_base + j
    lmax: int                # rows of the largest sub-list


def delta_slots(q_probe, delta: DeltaLists):
    """(Q, P, lmax) append-order row numbers of each query's probed delta
    sub-lists, -1 past a sub-list's end and at a probe id outside
    ``[0, C)``."""
    C = delta.off.numel() - 1
    probe = q_probe.long()
    live = (probe >= 0) & (probe < C)
    c = probe.clamp(0, C - 1)
    off = delta.off.long()
    pos = off[c][..., None] + torch.arange(delta.lmax, device=probe.device)
    ok = live[..., None] & (pos < off[c + 1][..., None])
    rows = delta.perm.long()[pos.clamp(max=max(delta.perm.numel() - 1, 0))]
    return torch.where(ok, rows, torch.full_like(rows, -1))


def _delta_ids(rows, delta: DeltaLists):
    return torch.where(rows >= 0, rows + delta.n_base,
                       torch.full_like(rows, -1)).to(torch.int32)


def ivf_probe(queries, centroids, nprobe: int):
    """Per-query ``nprobe`` nearest coarse centroids: queries (Q, D)
    L2-normalized, centroids (C, D) unit-norm -> ids (Q, nprobe) int32,
    best first.  A stable descending sort breaks ties towards the lower
    centroid id, as `lax.top_k` does in the reference (``torch.topk`` on a
    GPU promises no tie order)."""
    cs = queries.float() @ centroids.T
    order = torch.sort(cs, dim=1, descending=True, stable=True).indices
    return order[:, :min(nprobe, centroids.shape[0])].to(torch.int32)


def _topk_candidates(cand_s, cand_i, k: int):
    """Top-k of (Q, n) masked candidates with the empty-slot contract:
    -inf / -1 past the valid ones, padded when k > n."""
    kk = min(k, cand_s.shape[1])
    scores, pos = torch.topk(cand_s, kk, dim=1)
    idx = torch.gather(cand_i, 1, pos)
    fin = torch.isfinite(scores)
    idx = torch.where(fin, idx, torch.full_like(idx, -1)).to(torch.int32)
    scores = torch.where(fin, scores, torch.full_like(scores, float("-inf")))
    if kk < k:
        q = cand_s.shape[0]
        scores = torch.cat([scores, scores.new_full((q, k - kk),
                                                    float("-inf"))], 1)
        idx = torch.cat([idx, idx.new_full((q, k - kk), -1)], 1)
    return scores, idx


def _masked(sims, ids):
    q = sims.shape[0]
    sims = torch.where(ids >= 0, sims, torch.full_like(sims, float("-inf")))
    return sims.reshape(q, -1), ids.reshape(q, -1)


def _with_delta(sims, ids, dsims, dids):
    d_s, d_i = _masked(dsims, dids)
    return torch.cat([sims, d_s], 1), torch.cat([ids, d_i], 1)


def ivf_scan_plain(queries, q_probe, sup_cm, ids_cm, inv_cm, k: int,
                   delta: Optional[DeltaLists] = None):
    """Plain version of kernel 4: queries (Q, D) f32 L2-normalized,
    q_probe (Q, P) int32 list ids; returns (scores (Q, k) f32 descending,
    ids (Q, k) int32).  With ``delta`` the probed delta sub-lists join the
    candidates."""
    probe = q_probe.long()
    q = queries.float()
    lists = sup_cm[probe]                                    # (Q, P, L, D)
    sims = torch.einsum("qd,qpld->qpl", q, lists) * inv_cm[probe]
    sims, ids = _masked(sims, ids_cm[probe])
    if delta is not None and delta.lmax:
        rows = delta_slots(q_probe, delta)                   # (Q, P, lmax)
        safe = rows.clamp_min(0)
        dsims = torch.einsum("qd,qpld->qpl", q, delta.rows[safe]) \
            * delta.inv[safe]
        sims, ids = _with_delta(sims, ids, dsims, _delta_ids(rows, delta))
    return _topk_candidates(sims, ids, k)


def adc_table(queries, codebooks):
    """Per-query ADC tables ``(Q, m, K)``: subvector dot products of each
    query with every codebook entry of its subspace."""
    m, _, dsub = codebooks.shape
    qs = queries.float().reshape(len(queries), m, dsub)
    return torch.einsum("qmd,mkd->qmk", qs, codebooks)


def ivfpq_adc_plain(queries, q_probe, codes_cm, ids_cm, inv_cm, anchors,
                    codebooks, k: int, m: int, nbits: int,
                    delta: Optional[DeltaLists] = None):
    """Plain version of kernel 5: the ADC shortlist.  codes_cm (C, MB, L)
    packed uint8 code-major; anchors (C, D); codebooks (m, 2^nbits, D/m).
    Returns (scores (Q, k), ids (Q, k)) like `ivf_scan_plain`.  With
    ``delta`` the probed delta sub-lists' codes join the scan, each scored
    with the anchor dot of the slot that probes it."""
    probe = q_probe.long()
    qn, p = probe.shape
    lut = adc_table(queries, codebooks)                      # (Q, m, K)
    nk = lut.shape[2]
    codes = unpack_codes_cm(codes_cm[probe], m, nbits)       # (Q, P, m, L)
    g = torch.gather(lut[:, None].expand(qn, p, m, nk), 3, codes)
    aq = torch.einsum("qd,qpd->qp", queries.float(), anchors[probe])
    sims = (g.sum(dim=2) + aq[:, :, None]) * inv_cm[probe]   # (Q, P, L)
    sims, ids = _masked(sims, ids_cm[probe])
    if delta is not None and delta.lmax:
        rows = delta_slots(q_probe, delta)                   # (Q, P, lmax)
        safe = rows.clamp_min(0)
        dc = delta.codes[:, safe].permute(1, 2, 0, 3)        # (Q, P, MB, lm)
        dcodes = unpack_codes_cm(dc, m, nbits)               # (Q, P, m, lm)
        dg = torch.gather(lut[:, None].expand(qn, p, m, nk), 3, dcodes)
        dsims = (dg.sum(dim=2) + aq[:, :, None]) * delta.inv[safe]
        sims, ids = _with_delta(sims, ids, dsims, _delta_ids(rows, delta))
    return _topk_candidates(sims, ids, k)


def ivf_topk_reference(queries, centroids, sup_cm, ids_cm, k: int,
                       nprobe: int):
    """Oracle of the raw IVF search: probe, then score the probed lists
    with row norms taken on the fly (as `knn_topk_reference` does), so
    ``nprobe == C`` equals the exact scan."""
    nprobe = min(nprobe, centroids.shape[0])
    q = queries.float()
    probe = ivf_probe(q, centroids, nprobe).long()
    lists = sup_cm[probe].float()                            # (Q, P, L, D)
    sims = torch.einsum("qd,qpld->qpl", q, lists) \
        * torch.rsqrt((lists * lists).sum(-1) + 1e-12)
    return _topk_candidates(*_masked(sims, ids_cm[probe]),
                            min(k, probe.shape[1] * sup_cm.shape[1]))


def ivfpq_adc_reference(queries, centroids, anchors, codebooks, codes_cm,
                        ids_cm, inv_cm, k: int, nprobe: int, m: int,
                        nbits: int):
    """Decode-based ADC oracle: reconstruct every list row as
    ``anchor + concat_j codebook[j, code_j]`` and score the probed lists
    densely against the reconstructions, times the stored inverse norms.
    By linearity this equals the LUT-gather score term for term."""
    C, _, L = codes_cm.shape
    nprobe = min(nprobe, C)
    q = queries.float()
    probe = ivf_probe(q, centroids, nprobe).long()
    codes = unpack_codes_cm(codes_cm, m, nbits)              # (C, m, L)
    parts = torch.stack([codebooks[j][codes[:, j, :]] for j in range(m)],
                        dim=2)                               # (C, L, m, dsub)
    recon = anchors[:, None, :] + parts.reshape(C, L, -1)    # (C, L, D)
    sims = torch.einsum("qd,qpld->qpl", q, recon[probe]) * inv_cm[probe]
    return _topk_candidates(*_masked(sims, ids_cm[probe]),
                            min(k, nprobe * L))
