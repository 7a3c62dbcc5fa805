"""Product quantization for IVF list storage (the port's copy of
`repro.kernels.knn_ivf.pq`).

Each list row is stored as ``m`` one-byte (or half-byte) codes of its
RESIDUAL against its cluster's raw-space anchor; a query builds one
``(m, 2^nbits)`` lookup table of subvector dot products and scores a row by
``m`` table gathers (asymmetric distance computation, ADC)::

    dot(q, x_i)  ~=  q @ anchor_c  +  sum_j  LUT[j, code_ij]

The numpy functions are the reference's (`_kmeans_subspace` groups a
center's members by one stable sort instead of a mask a center, which
selects the same rows in the same order), so a port build and a JAX build
on the same rows and seed give the same bytes.
``unpack_codes_cm`` is the torch twin of the reference's code-major
unpack, used by the plain ADC version and the decode oracle.
"""
from __future__ import annotations

import numpy as np
import torch


def effective_m(d: int, m: int) -> int:
    """Largest divisor of ``d`` that is <= the requested ``m`` — PQ needs
    equal-width subspaces, and silently failing on odd embedding dims would
    make spec strings dim-dependent."""
    m = max(1, min(m, d))
    while d % m:
        m -= 1
    return m


def default_m(d: int) -> int:
    """~D/8 subspaces (8 dims per code, one byte summarizing 32 raw bytes),
    capped at 64 — past that the per-row LUT-gather count grows with no
    retrieval benefit at routing-embedding dims."""
    return effective_m(d, min(64, max(1, d // 8)))


def _kmeans_subspace(x: np.ndarray, n_centers: int, seed: int,
                     iters: int) -> np.ndarray:
    """Plain Lloyd k-means on one residual subspace (Euclidean).  Empty
    centers are reseeded from random rows; with fewer rows than centers the
    init samples with replacement (duplicate centers are harmless — argmin
    ties break to the lowest index)."""
    rng = np.random.default_rng(seed)
    n = len(x)
    cent = x[rng.choice(n, size=n_centers, replace=n < n_centers)].copy()
    for _ in range(iters):
        d2 = (np.square(x).sum(1, keepdims=True)
              - 2.0 * (x @ cent.T) + np.square(cent).sum(1))
        assign = np.argmin(d2, axis=1)
        # each center's members as one slice of the rows sorted stably by
        # center: the rows `x[assign == c]` selects, in the same order, so
        # the same means bit for bit, without a mask over all rows a center
        order = np.argsort(assign, kind="stable")
        xs = x[order]
        ends = np.cumsum(np.bincount(assign, minlength=n_centers))
        for c in range(n_centers):
            s0 = ends[c - 1] if c else 0
            if ends[c] > s0:
                cent[c] = xs[s0:ends[c]].mean(axis=0)
            else:
                cent[c] = x[rng.integers(0, n)]
    return cent.astype(np.float32)


def train_pq(residuals: np.ndarray, m: int, nbits: int, seed: int = 0,
             iters: int = 8, max_train_rows: int = 32768) -> np.ndarray:
    """Per-subspace codebooks ``(m, 2^nbits, D/m)`` trained on the residual
    rows (subsampled to ``max_train_rows`` — codebook quality saturates well
    below full corpus size, build time does not)."""
    n, d = residuals.shape
    assert d % m == 0, (d, m)
    rng = np.random.default_rng(seed)
    if n > max_train_rows:
        residuals = residuals[rng.choice(n, size=max_train_rows,
                                         replace=False)]
    sub = residuals.reshape(len(residuals), m, d // m)
    return np.stack([_kmeans_subspace(sub[:, j], 2 ** nbits, seed + j, iters)
                     for j in range(m)])


def encode_pq(residuals: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Nearest-centroid code per subspace: ``(N, D)`` residuals ->
    ``(N, m)`` uint8 codes (values < 2^nbits)."""
    n, d = residuals.shape
    m, k, dsub = codebooks.shape
    sub = residuals.reshape(n, m, dsub)
    codes = np.empty((n, m), np.uint8)
    for j in range(m):
        d2 = (np.square(sub[:, j]).sum(1, keepdims=True)
              - 2.0 * (sub[:, j] @ codebooks[j].T)
              + np.square(codebooks[j]).sum(1))
        codes[:, j] = np.argmin(d2, axis=1)
    return codes


def decode_pq(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Reconstruct residuals from codes: ``(N, m)`` -> ``(N, D)``.  The ADC
    identity (score == dot against the reconstruction) makes this the oracle
    twin of every LUT-gather scoring path."""
    n, m = codes.shape
    return np.stack([codebooks[j, codes[:, j]] for j in range(m)],
                    axis=1).reshape(n, -1)


def pack_codes(codes: np.ndarray, nbits: int) -> np.ndarray:
    """``(N, m)`` codes -> packed ``(N, m*nbits/8)`` uint8.  nbits=8 is the
    identity; nbits=4 packs code pairs as ``lo | hi<<4`` (m must be even)."""
    if nbits == 8:
        return np.ascontiguousarray(codes, np.uint8)
    if nbits == 4:
        assert codes.shape[-1] % 2 == 0, codes.shape
        lo = codes[..., 0::2].astype(np.uint8)
        hi = codes[..., 1::2].astype(np.uint8)
        return (lo | (hi << 4)).astype(np.uint8)
    raise ValueError(f"nbits must be 4 or 8, got {nbits}")


def unpack_codes(packed: np.ndarray, m: int, nbits: int) -> np.ndarray:
    """Inverse of ``pack_codes`` (numpy): packed bytes -> ``(..., m)`` int32."""
    p = packed.astype(np.int32)
    if nbits == 8:
        return p
    out = np.empty(p.shape[:-1] + (m,), np.int32)
    out[..., 0::2] = p & 0xF
    out[..., 1::2] = (p >> 4) & 0xF
    return out


def unpack_codes_cm(packed: torch.Tensor, m: int, nbits: int) -> torch.Tensor:
    """Code-major unpack: packed ``(..., MB, L)`` uint8 blocks -> ``(..., m,
    L)`` int64 codes.  nbits=4 interleaves the nibble pairs along the
    SUBSPACE axis: byte ``b`` holds subspace ``2b`` in its low nibble and
    ``2b + 1`` in its high nibble, as ``pack_codes`` writes them."""
    p = packed.long()
    if nbits == 8:
        return p
    lo = p & 0xF                                   # subspaces 0, 2, 4, ...
    hi = (p >> 4) & 0xF                            # subspaces 1, 3, 5, ...
    inter = torch.stack([lo, hi], dim=-2)          # (..., MB, 2, L)
    return inter.reshape(*p.shape[:-2], m, p.shape[-1])


def adc_lut(queries: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Per-query ADC tables: ``(Q, D)`` x ``(m, K, dsub)`` ->
    ``(Q, m, K)`` of subvector dot products."""
    q_n, d = queries.shape
    m, k, dsub = codebooks.shape
    qs = queries.reshape(q_n, m, dsub)
    return np.einsum("qmd,mkd->qmk", qs, codebooks,
                     optimize=True).astype(np.float32)


def expand_codebooks(codebooks: np.ndarray) -> np.ndarray:
    """Block-diagonal ``(m*K, D)`` expansion of the codebooks: row ``j*K+c``
    holds ``codebooks[j, c]`` in columns ``[j*dsub, (j+1)*dsub)`` and zeros
    elsewhere, so the whole per-query LUT is ONE ``(BQ, D) @ (D, m*K)``
    matmul."""
    m, k, dsub = codebooks.shape
    mat = np.zeros((m * k, m * dsub), np.float32)
    for j in range(m):
        mat[j * k:(j + 1) * k, j * dsub:(j + 1) * dsub] = codebooks[j]
    return mat
