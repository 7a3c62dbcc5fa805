"""Wrapper of the exact top-k kernel (`kernel.cu`); replaces
`repro.kernels.knn_topk.ops.knn_topk`.

Contract: scores (Q, k) f32 sorted descending, ids (Q, k) int32 with ties
to the lower row id, -inf / -1 in the slots no support row fills (k > N),
NaN rows masked.  k is not clamped to N here: callers that want at most N
results clamp it themselves, as `KNNRouter` does.  CPU tensors take the
plain version (`ref.py`), which takes any k >= 1, as the reference does;
CUDA tensors launch the kernel or raise.  k <= 128 is one launch: a scan
over a grid sized to the card that keeps a running top-k per block and
query, and whose last block merges the blocks' lists.  k > 128 runs the
keyed scan with a per-query histogram of the keys' top 10 bits (refined by
up to two histograms of the next 11 bits where one bin holds too many), a
compaction into a bounded candidate buffer and the shared radix select over
it (`scratch_shapes`).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import knn_topk_reference

KMAX_WARP = 128   # kernel.cu: KMAX, the one-launch path
QUERY_TILE = 16   # kernel.cu: BQ, queries per block
HIST_BINS = 1024  # kernel.cu: NBINS, the k > 128 path's histogram
REFINE_BINS = 2048  # kernel.cu: RBINS, a refine digit's histogram
REFINE_LEVELS = 2   # kernel.cu: REFINE_LEVELS (10 + 2 x 11 bits)
_GRID_Y_MAX = 65535
_INT_MAX = 2**31 - 1
#: candidate buffer of the k > 128 path: cap = min(N, max(4 k, 4,096))
CAND_MIN = 4096


def candidate_cap(N: int, k: int) -> int:
    """Per-query candidate buffer of the k > 128 path."""
    return min(N, max(4 * k, CAND_MIN))


def check_limits(Q: int, N: int, k: int) -> None:
    """Raise ValueError where a CUDA call of these sizes cannot launch: row
    ids are 32-bit in the kernel, and the k > 128 path's compaction grid
    has one row of blocks per query."""
    if N > _INT_MAX - 256:
        raise ValueError(f"knn_topk: N={N} rows is too large for one call")
    if k > KMAX_WARP and Q > _GRID_Y_MAX:
        raise ValueError(f"knn_topk: k={k} > {KMAX_WARP} takes at most "
                         f"{_GRID_Y_MAX} queries a call (grid rows), got "
                         f"Q={Q}")


def scratch_shapes(Q: int, N: int, k: int, nrb: int) -> dict:
    """Device scratch of one CUDA call, by name -> (shape, dtype).
    k <= 128: each of the ``nrb`` row ranges of a query tile writes its
    sorted k keys per query (``part``); ``ticket`` holds one counter per
    query tile, zero between calls (the kernel's last block resets it).
    k > 128: one key per (query, row), the (Q, 1,024) histogram and the
    (Q, 2, 2,048) histograms of its two refine digits, the candidate
    buffer, its fill counts and the overflow flags."""
    if k <= KMAX_WARP:
        return {"part": ((Q, nrb, k), torch.int64),
                "ticket": ((-(-Q // QUERY_TILE),), torch.int32)}
    cap = candidate_cap(N, k)
    return {"keys": ((Q, N), torch.int64),
            "ghist": ((Q, HIST_BINS), torch.int32),
            "ghist2": ((Q, REFINE_LEVELS, REFINE_BINS), torch.int32),
            "cand": ((Q, cap), torch.int64),
            "ccount": ((Q,), torch.int32),
            "overflow": ((Q,), torch.int32)}


def _lib():
    lib = _build.load("knn_topk")
    if lib.knn_topk_launch.argtypes is None:
        lib.knn_topk_plan.restype = ctypes.c_int
        lib.knn_topk_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.knn_topk_device_launches.restype = ctypes.c_ulonglong
        lib.knn_topk_device_launches.argtypes = []
        lib.knn_topk_launch.restype = ctypes.c_int
        lib.knn_topk_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8
            + [ctypes.c_int, ctypes.c_void_p])
    return lib


#: ticket counters of the one-launch path, by (device, stream): allocated
#: with zeros once, left at zero by every call's last block
_tickets: dict = {}


def _ticket(dev: torch.device, n: int) -> torch.Tensor:
    key = (dev.index, _build.stream_ptr(dev))
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _tickets[key] = t
    return t


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
    bf16 = support.dtype == torch.bfloat16
    if bf16 and D % 2:
        raise ValueError(f"knn_topk: a bf16 support needs an even D (rows "
                         f"are copied 4 bytes at a time), got D={D}")
    check_limits(Q, N, k)
    dev = queries.device
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0 or N == 0:
        return out_s.fill_(float("-inf")), out_i.fill_(-1)
    lib = _lib()
    nrb = ctypes.c_int(0)
    _build.check(lib.knn_topk_plan(int(bf16), Q, N, D, k, ctypes.byref(nrb)),
                 "knn_topk")
    shapes = scratch_shapes(Q, N, k, nrb.value)
    ptr = dict.fromkeys(("part", "ticket", "keys", "ghist", "ghist2", "cand",
                         "ccount", "overflow"), 0)
    knn_topk.last_overflow = None
    if k <= KMAX_WARP:
        part = torch.empty(shapes["part"][0], dtype=torch.int64, device=dev)
        ticket = _ticket(dev, shapes["ticket"][0][0])
        ptr.update(part=part.data_ptr(), ticket=ticket.data_ptr())
    else:
        # the histograms, fill counts and flags in one zeroed buffer
        nh = HIST_BINS + REFINE_LEVELS * REFINE_BINS
        zq = torch.zeros(Q * (nh + 2), dtype=torch.int32, device=dev)
        keys = torch.empty(shapes["keys"][0], dtype=torch.int64, device=dev)
        cand = torch.empty(shapes["cand"][0], dtype=torch.int64, device=dev)
        ptr.update(keys=keys.data_ptr(), cand=cand.data_ptr(),
                   ghist=zq.data_ptr(),
                   ghist2=zq[Q * HIST_BINS:].data_ptr(),
                   ccount=zq[Q * nh:].data_ptr(),
                   overflow=zq[Q * (nh + 1):].data_ptr())
        knn_topk.last_overflow = zq[Q * (nh + 1):]
    before = lib.knn_topk_device_launches()
    err = lib.knn_topk_launch(
        queries.data_ptr(), support.data_ptr(), int(bf16), out_s.data_ptr(),
        out_i.data_ptr(), Q, N, D, k, nrb.value, ptr["part"], ptr["ticket"],
        ptr["keys"], ptr["ghist"], ptr["ghist2"], ptr["cand"], ptr["ccount"],
        ptr["overflow"], candidate_cap(N, k), _build.stream_ptr(dev))
    _build.check(err, "knn_topk")
    knn_topk.launches += 1
    knn_topk.last_cuda_launches = lib.knn_topk_device_launches() - before
    return out_s, out_i


#: calls that launched the kernel (one per call on a CUDA tensor: k <= 128
#: is a single CUDA launch; k > 128 zeroes its histograms, then runs the
#: keyed scan, two refine passes, the compaction, ceil(k / 1,024) selection
#: rounds over the candidates and as many flagged full-key rounds)
knn_topk.launches = 0
#: CUDA kernels the last CUDA call launched from the kernel library (the
#: library's own count: 1 for k <= 128; for k > 128 the scan, two refine
#: passes, the compaction and two selection passes of ceil(k / 1,024) rounds,
#: beside the zero fill of the histograms that torch launches)
knn_topk.last_cuda_launches = 0
#: the (Q,) int32 overflow flags of the last k > 128 CUDA call, on the
#: device (1 where a query's candidates overflowed the buffer and all its
#: keys were selected over; read after the call), else None
knn_topk.last_overflow = None
