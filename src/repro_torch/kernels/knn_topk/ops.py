"""Wrapper of the exact top-k kernel (`kernel.cu`); replaces
`repro.kernels.knn_topk.ops.knn_topk`.

Contract: scores (Q, k) f32 sorted descending, ids (Q, k) int32, and
-inf / -1 in the slots no support row fills (k > N).  k is not clamped to N
here: callers that want at most N results clamp it themselves, as
`KNNRouter` does.  CPU tensors take the plain version (`ref.py`), which
takes any k >= 1, as the reference does; CUDA tensors launch the kernel
(k <= 128: warp selection per chunk and merges; k > 128: one key per
support row and the radix select shared with the IVF kernels, in rounds of
1,024) or raise.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import knn_topk_reference

KMAX_WARP = 128  # kernel.cu: KMAX, the chunk-and-merge path
_CHUNK = 512   # kernel.cu: CH, support rows per pass-1 block
_MERGE = 1024  # kernel.cu: MERGE, candidates per warp in a merge pass
_GRID_Y_MAX = 65535


def _lib():
    lib = _build.load("knn_topk")
    fn = lib.knn_topk_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    return lib


def knn_topk(queries: torch.Tensor, support: torch.Tensor, k: int):
    """queries (Q, D) f32 L2-normalized; support (N, D) f32 or bf16 raw
    (normalized inside).  Returns (scores (Q, k), ids (Q, k))."""
    if queries.ndim != 2 or support.ndim != 2 \
            or queries.shape[1] != support.shape[1]:
        raise ValueError(f"knn_topk: queries (Q, D) and support (N, D) "
                         f"expected, got {tuple(queries.shape)} and "
                         f"{tuple(support.shape)}")
    if queries.device != support.device:
        raise ValueError("knn_topk: queries and support on different devices")
    if k < 1:
        raise ValueError(f"knn_topk needs k >= 1, got k={k}")
    if queries.device.type == "cpu":
        return knn_topk_reference(queries, support, k)
    if queries.device.type != "cuda":
        raise ValueError(f"knn_topk: unsupported device {queries.device}")
    if queries.dtype != torch.float32 \
            or support.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"knn_topk: f32 queries and f32/bf16 support "
                        f"expected, got {queries.dtype}, {support.dtype}")
    if not (queries.is_contiguous() and support.is_contiguous()):
        raise ValueError("knn_topk: queries and support must be contiguous")
    Q, D = queries.shape
    N = support.shape[0]
    dev = queries.device
    nch = -(-N // _CHUNK)
    if nch > _GRID_Y_MAX or Q > _GRID_Y_MAX:
        raise ValueError(f"knn_topk: N={N} rows and Q={Q} queries must be "
                         f"<= {_GRID_Y_MAX * _CHUNK} and {_GRID_Y_MAX} "
                         f"(grid axes)")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0 or N == 0:
        return out_s.fill_(float("-inf")), out_i.fill_(-1)
    if k <= KMAX_WARP:
        n1 = -(-nch * k // _MERGE)
        bufs = [torch.empty((Q * n * k,), dtype=dt, device=dev)
                for n in (nch, n1) for dt in (torch.float32, torch.int32)]
        keys = None
    else:
        bufs = [None] * 4
        keys = torch.empty((Q, N), dtype=torch.int64, device=dev)
    ptr = [0 if t is None else t.data_ptr() for t in (*bufs, keys)]
    err = _lib().knn_topk_launch(
        queries.data_ptr(), support.data_ptr(),
        int(support.dtype == torch.bfloat16), out_s.data_ptr(),
        out_i.data_ptr(), *ptr, Q, N, D, k, _build.stream_ptr(dev))
    _build.check(err, "knn_topk")
    knn_topk.launches += 1
    return out_s, out_i


#: calls that launched the kernel (one per call on a CUDA tensor; each call
#: issues the chunk pass and then merge passes until one list of k is left,
#: 3 kernels in all at N = 70,000, k = 10; for k > 128 the keyed chunk pass
#: and ceil(k / 1,024) selection rounds)
knn_topk.launches = 0
