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
"""
from __future__ import annotations

import torch

from .pq import unpack_codes_cm


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


def ivf_scan_plain(queries, q_probe, sup_cm, ids_cm, inv_cm, k: int):
    """Plain version of kernel 4: queries (Q, D) f32 L2-normalized,
    q_probe (Q, P) int32 list ids; returns (scores (Q, k) f32 descending,
    ids (Q, k) int32)."""
    probe = q_probe.long()
    lists = sup_cm[probe]                                    # (Q, P, L, D)
    sims = torch.einsum("qd,qpld->qpl", queries.float(), lists) * inv_cm[probe]
    return _topk_candidates(*_masked(sims, ids_cm[probe]), k)


def adc_table(queries, codebooks):
    """Per-query ADC tables ``(Q, m, K)``: subvector dot products of each
    query with every codebook entry of its subspace."""
    m, _, dsub = codebooks.shape
    qs = queries.float().reshape(len(queries), m, dsub)
    return torch.einsum("qmd,mkd->qmk", qs, codebooks)


def ivfpq_adc_plain(queries, q_probe, codes_cm, ids_cm, inv_cm, anchors,
                    codebooks, k: int, m: int, nbits: int):
    """Plain version of kernel 5: the ADC shortlist.  codes_cm (C, MB, L)
    packed uint8 code-major; anchors (C, D); codebooks (m, 2^nbits, D/m).
    Returns (scores (Q, k), ids (Q, k)) like `ivf_scan_plain`."""
    probe = q_probe.long()
    qn, p = probe.shape
    lut = adc_table(queries, codebooks)                      # (Q, m, K)
    codes = unpack_codes_cm(codes_cm[probe], m, nbits)       # (Q, P, m, L)
    g = torch.gather(lut[:, None].expand(qn, p, m, lut.shape[2]), 3, codes)
    aq = torch.einsum("qd,qpd->qp", queries.float(), anchors[probe])
    sims = (g.sum(dim=2) + aq[:, :, None]) * inv_cm[probe]   # (Q, P, L)
    return _topk_candidates(*_masked(sims, ids_cm[probe]), k)


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
