"""Mesh-sharded kNN retrieval over ``torch.distributed`` (mirrors
`repro.core.sharded_knn`): exact, IVF and IVF-PQ, each rank running the
port's hand-written kernel on its own shard.

SPMD form: one process per rank; every rank of ``mesh`` (a
``DeviceMesh``, `launch.mesh`) calls the same function with the same
replicated queries, as every device runs the reference's ``shard_map``
body.  A rank's shard id is its mesh coordinate folded mixed-radix over
the axes in mesh order (`launch.mesh.flat_shard_id`), which is its rank in
the group over the whole mesh (`launch.mesh.mesh_group`).

Exact (`sharded_knn_topk`): the support is padded to a multiple of the
rank count and rank r holds rows ``[r rows_per, (r + 1) rows_per)``
(`shard_support` pads only the rank's own rows);
kernel 1 (`kernels.knn_topk.ops.knn_topk`) finds ``kk = min(k_local or
k, rows_per)`` candidates there, global ids are ``ix + r rows_per`` and
padding rows are masked to -inf / -1.  `_allgather_merge` all-gathers
every rank's (Q, kk) scores and ids (O(ranks k), whatever the support's
size) and merges them into the global top-k with a stable descending
sort over the shard-major layout, so ties keep the lower position, as
``lax.top_k`` does in the reference.

IVF (`sharded_ivf_topk`): the centroids are replicated, so every rank
computes the same probe set; rank r owns lists ``[r cp, (r + 1) cp)`` of
the lists padded to a multiple of the rank count, plus one empty dummy
list (ids -1, inverse norms 0) at local id ``cp``.  Owned probes map to
local ids, every other probe to the dummy, and kernel 4
(`kernels.knn_ivf.ops.ivf_scan`) scans them; the same merge follows.

IVF-PQ (`sharded_ivfpq_topk`): the same layout over the packed code
lists, with the rank's anchors (a zero dummy row); kernel 5 (`ivfpq_adc`)
gives each rank's ADC shortlist of ``kk = min(max(rerank, 1) k, n_rows,
nprobe L)``, the merge gives the global one, and it is re-ranked exactly
against the cold tier (`rerank_stored_inv`), which stays where the
single-card index keeps it.

Streaming (`DynamicIVFIndex`): both IVF functions search the frozen base
sharded, then merge the delta tier's exact scan (the staged backends'
semantics).  A rank's lists are laid out once for each base object
(`_list_shard`, a cache keyed by the index, dropped with it), so a
compaction that swaps the base is re-laid on the next call with no
explicit redistribution step.

On a CPU tensor each kernel runs its plain version and the group is a
gloo one; on a CUDA tensor each kernel launches (never its plain
version), on an NCCL group or on a gloo one (ranks sharing one card),
which takes the CUDA buffers as they are (`distributed.comm`).
"""
from __future__ import annotations

import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import comm
from repro_torch.kernels.knn_ivf.ops import (DEFAULT_NPROBE, DEFAULT_RERANK,
                                             DynamicIVFIndex, IVFPQIndex,
                                             _merge_delta, _queries,
                                             ivf_scan, ivfpq_adc,
                                             rerank_stored_inv)
from repro_torch.kernels.knn_ivf.ref import ivf_probe
from repro_torch.kernels.knn_topk.ops import knn_topk
from repro_torch.launch.mesh import flat_shard_id, mesh_group


class LocalShard(NamedTuple):
    """One rank's rows of a support row-sharded over a mesh: ``rows``
    (rows_per, D), zero past the support's ``n_valid`` rows."""
    rows: torch.Tensor
    n_valid: int


def shard_support(support: torch.Tensor, mesh) -> LocalShard:
    """This rank's `LocalShard` of the full ``support`` (N, D): rows
    ``[r rows_per, (r + 1) rows_per)`` of the support padded to a multiple
    of the mesh's size, copied out (only this rank's rows are padded)."""
    n, n_shards = support.shape[0], mesh.size()
    rows_per = -(-n // n_shards)
    lo = min(flat_shard_id(mesh) * rows_per, n)
    rows = support[lo:lo + rows_per]
    if rows.shape[0] < rows_per:
        rows = F.pad(rows, (0, 0, 0, rows_per - rows.shape[0]))
    return LocalShard(rows.contiguous(), n)


def _allgather_merge(sc, ix, k: int, group):
    """Gather every rank's (Q, kk) candidates (one collective of the scores
    and the ids' bits side by side) and merge to the global top-k: a stable
    descending sort over the shard-major candidates (rank 0's first), -inf
    / -1 past the valid ones."""
    qn, kk = sc.shape
    buf = torch.cat([sc, ix.to(torch.int32).view(torch.float32)], 1)
    got = comm.all_gather(buf, group)                        # (S, Q, 2 kk)
    s = got.shape[0]
    all_sc = got[..., :kk].permute(1, 0, 2).reshape(qn, s * kk)
    all_ix = got[..., kk:].contiguous().view(torch.int32) \
        .permute(1, 0, 2).reshape(qn, s * kk)
    kq = min(k, s * kk)
    order = torch.sort(all_sc, dim=1, descending=True,
                       stable=True).indices[:, :kq]
    top_sc = torch.gather(all_sc, 1, order)
    top_ix = torch.gather(all_ix, 1, order)
    top_ix = torch.where(torch.isfinite(top_sc), top_ix,
                         torch.full_like(top_ix, -1))
    if kq < k:
        top_sc = F.pad(top_sc, (0, k - kq), value=float("-inf"))
        top_ix = F.pad(top_ix, (0, k - kq), value=-1)
    return top_sc, top_ix


def sharded_knn_topk(queries, support, k: int, mesh, k_local: int = 0):
    """queries (Q, D) L2-normalized, replicated; support the full (N, D)
    rows (each rank takes its shard) or this rank's `LocalShard`.  Returns
    (scores (Q, k), global ids (Q, k)) on every rank.

    ``k_local``: each rank's candidate count for the merge (0: k, exact
    retrieval).  A smaller one cuts the all-gather by k / k_local at a
    bounded recall risk: with rows placed at random a shard holds
    Binomial(k, 1 / ranks) of the global top-k."""
    shard = support if isinstance(support, LocalShard) \
        else shard_support(support, mesh)
    rows_per = shard.rows.shape[0]
    q = queries.to(shard.rows.device, torch.float32).contiguous()
    kk = min(k_local or k, rows_per)
    sc, ix = knn_topk(q, shard.rows, kk)
    gix = ix + flat_shard_id(mesh) * rows_per
    valid = (ix >= 0) & (gix < shard.n_valid)
    sc = torch.where(valid, sc, torch.full_like(sc, float("-inf")))
    gix = torch.where(valid, gix, torch.full_like(gix, -1))
    return _allgather_merge(sc, gix, k, mesh_group(mesh))


# ---------------------------------------------------------------------------
# IVF and IVF-PQ: cluster lists sharded, quantizer state replicated
# ---------------------------------------------------------------------------

class _Lists(NamedTuple):
    """One rank's cluster lists: ``cp`` owned (zero-padded) lists and the
    dummy at local id ``cp``."""
    cp: int
    ids: torch.Tensor          # (cp + 1, L) int32, -1 padding
    inv: torch.Tensor          # (cp + 1, L) f32, 0 padding
    sup: torch.Tensor | None   # (cp + 1, L, D) f32 raw rows (IVF)
    codes: torch.Tensor | None  # (cp + 1, MB, L) uint8 (IVF-PQ)
    anchors: torch.Tensor | None  # (cp + 1, D) f32 (IVF-PQ)


_shards: dict = {}
_shards_lock = threading.Lock()


def _local(a: np.ndarray, lo: int, cp: int, fill, device) -> torch.Tensor:
    """Lists ``[lo, lo + cp)`` of the host array ``a`` (C, ...), padded
    with ``fill`` past C, plus one dummy list of ``fill``."""
    out = np.full((cp + 1,) + a.shape[1:], fill, a.dtype)
    part = a[lo:lo + cp]
    out[:len(part)] = part
    return torch.from_numpy(out).to(device)


def _lay_lists(index, mesh) -> _Lists:
    C = index.n_clusters
    cp = -(-C // mesh.size())
    lo = flat_shard_id(mesh) * cp
    dev = index.device
    ids = _local(index.ids_h, lo, cp, -1, dev)
    inv = _local(index.inv_h, lo, cp, 0, dev)
    if isinstance(index, IVFPQIndex):
        return _Lists(cp, ids, inv, None,
                      _local(index.codes_h, lo, cp, 0, dev),
                      _local(index.anchors_h, lo, cp, 0, dev))
    return _Lists(cp, ids, inv, _local(index.sup_h, lo, cp, 0, dev), None,
                  None)


def _list_shard(index, mesh) -> _Lists:
    """This rank's lists of a frozen index, laid out once for each (index
    object, mesh) and dropped when the index is: a compaction's new base
    is another object, so it is laid out on its first search."""
    key = id(index)
    with _shards_lock:
        ent = _shards.get(key)
    if ent is not None and ent[0]() is index and ent[1] is mesh:
        return ent[2]
    lists = _lay_lists(index, mesh)
    with _shards_lock:
        _shards[key] = (weakref.ref(index), mesh, lists)
    weakref.finalize(index, _shards.pop, key, None)
    return lists


def _local_probe(probe, mesh, cp: int):
    """Probe ids (Q, P) -> this rank's local list ids: an owned list's
    offset in the shard, every other probe the dummy list ``cp``."""
    loc = probe - flat_shard_id(mesh) * cp
    owned = (loc >= 0) & (loc < cp)
    return torch.where(owned, loc, torch.full_like(loc, cp)) \
        .to(torch.int32).contiguous()


def sharded_ivf_topk(queries, index, k: int, mesh,
                     nprobe: int = DEFAULT_NPROBE, block_q: int | None = None):
    """Mesh-sharded IVF retrieval: (scores (Q, k), global ids (Q, k)) on
    every rank, k clamped to ``min(k, n_rows, nprobe L)``.  ``block_q`` is
    kernel 4's query tile (`ivf_scan`).  A `DynamicIVFIndex` searches its
    frozen base sharded and merges the delta tier's exact scan."""
    if isinstance(index, DynamicIVFIndex):
        snap = index.fused_state()
        # repro: allow-unlocked: immutable snapshot taken under the lock
        base = snap.base
        q = _queries(queries, base)
        sc, ix = sharded_ivf_topk(q, base, k, mesh, nprobe, block_q)
        return _merge_delta(q, sc, ix, k, snap)
    nprobe = max(1, min(nprobe, index.n_clusters))
    k = min(k, index.n_rows, nprobe * index.list_size)
    lists = _list_shard(index, mesh)
    q = _queries(queries, index)
    probe = _local_probe(ivf_probe(q, index.centroids, nprobe), mesh,
                         lists.cp)
    sc, ix = ivf_scan(q, probe, lists.sup, lists.ids, lists.inv, k,
                      block_q=block_q)
    return _allgather_merge(sc, ix, k, mesh_group(mesh))


def sharded_ivfpq_topk(queries, index, k: int, mesh,
                       nprobe: int = DEFAULT_NPROBE,
                       rerank: int = DEFAULT_RERANK):
    """Mesh-sharded IVF-PQ retrieval.  Stage 1 (sharded): each rank's
    kernel 5 shortlist of kk over the probed lists it owns, merged to the
    global kk.  Stage 2 (replicated): the exact re-rank of that shortlist
    against the cold tier to k; ``rerank=0`` returns the merged ADC top-k.
    A `DynamicIVFIndex` as in `sharded_ivf_topk`."""
    if isinstance(index, DynamicIVFIndex):
        snap = index.fused_state()
        # repro: allow-unlocked: immutable snapshot taken under the lock
        base = snap.base
        q = _queries(queries, base)
        sc, ix = sharded_ivfpq_topk(q, base, k, mesh, nprobe, rerank)
        return _merge_delta(q, sc, ix, k, snap)
    nprobe = max(1, min(nprobe, index.n_clusters))
    cand = nprobe * index.list_size
    k = min(k, index.n_rows, cand)
    kk = min(max(rerank, 1) * k, index.n_rows, cand)
    lists = _list_shard(index, mesh)
    q = _queries(queries, index)
    probe = _local_probe(ivf_probe(q, index.centroids, nprobe), mesh,
                         lists.cp)
    sc, ix = ivfpq_adc(q, probe, lists.codes, lists.ids, lists.inv,
                       lists.anchors, index.codebooks, kk, m=index.m,
                       nbits=index.nbits)
    sc, ix = _allgather_merge(sc, ix, kk, mesh_group(mesh))
    if not rerank:
        return sc[:, :k], ix[:, :k]
    return rerank_stored_inv(q, index.sup_flat, index.inv_flat, ix, k)
