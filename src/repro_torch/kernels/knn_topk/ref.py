"""Plain-torch version of exact cosine top-k retrieval (the twin of
`repro.kernels.knn_topk.ref.knn_topk_reference`): queries are cast to the
support dtype, the dot products and row norms accumulate in f32."""
from __future__ import annotations

import torch


def knn_topk_reference(queries, support, k: int):
    """queries (Q, D) L2-normalized; support (N, D) raw.
    Returns (scores (Q, k) f32 descending, ids (Q, k) int32); slots past
    N hold -inf / -1."""
    q = queries.to(support.dtype).float()
    s = support.float()
    inv = torch.rsqrt((s * s).sum(1) + 1e-12)
    sims = (q @ s.T) * inv[None, :]
    kk = min(k, s.shape[0])
    scores, idx = torch.topk(sims, kk, dim=1)
    idx = idx.to(torch.int32)
    # torch.topk over -inf still returns real row ids: an empty slot must
    # never alias a support row (merge_topk emits -1 there)
    idx = torch.where(torch.isfinite(scores), idx, torch.full_like(idx, -1))
    scores = torch.where(torch.isfinite(scores), scores,
                         torch.full_like(scores, float("-inf")))
    if kk < k:
        pad = k - kk
        scores = torch.cat([scores, scores.new_full((len(q), pad),
                                                    float("-inf"))], 1)
        idx = torch.cat([idx, idx.new_full((len(q), pad), -1)], 1)
    return scores, idx
