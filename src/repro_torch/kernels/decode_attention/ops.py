"""Wrapper of the decode attention kernel (`kernel.cu`); replaces
`repro.kernels.decode_attention.ops.decode_attention`, with a (B,)
position vector instead of one scalar position.

q (B, H, hd), cache_k / cache_v (B, S, KV, hd), pos (B,) int32 ->
(B, H, hd) in q.dtype.  CPU tensors take the plain version (`ref.py`);
CUDA tensors launch the kernels or raise: one call launches the split
kernel over spans of `SPLIT` cache rows and the combine kernel that merges
the spans' partials (`kernel.cu`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import decode_attention_reference

HEAD_DIMS = (64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)
GMAX = 16      # kernel.cu: GMAX, query heads per KV head
SPLIT = 64     # kernel.cu: SPLIT, cache rows a split block owns


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def decode_attention(q, cache_k, cache_v, pos, *, ring=False):
    """q: (B, H, hd); cache_k/v: (B, S, KV, hd); pos: (B,) int32."""
    if q.ndim != 3 or cache_k.ndim != 4 or cache_k.shape != cache_v.shape \
            or cache_k.shape[0] != q.shape[0] \
            or cache_k.shape[3] != q.shape[2] or q.shape[1] % cache_k.shape[2]:
        raise ValueError(f"decode_attention: q (B, H, hd) and cache "
                         f"(B, S, KV, hd) with KV | H expected, got "
                         f"{tuple(q.shape)}, {tuple(cache_k.shape)}")
    if pos.shape != (q.shape[0],):
        raise ValueError(f"decode_attention: pos must have shape "
                         f"({q.shape[0]},), got {tuple(pos.shape)}")
    if not (q.device == cache_k.device == cache_v.device == pos.device):
        raise ValueError("decode_attention: inputs on different devices")
    if q.device.type == "cpu":
        return decode_attention_reference(q, cache_k, cache_v, pos, ring=ring)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, hd = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    if q.dtype not in DTYPES or cache_k.dtype != q.dtype \
            or cache_v.dtype != q.dtype or pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: f32/bf16 q and cache of one "
                        f"dtype and int32 pos expected, got {q.dtype}, "
                        f"{cache_k.dtype}, {cache_v.dtype}, {pos.dtype}")
    if hd not in HEAD_DIMS or not 1 <= G <= GMAX:
        raise ValueError(f"decode_attention: head_dim {hd} must be in "
                         f"{HEAD_DIMS} and H/KV={G} in [1, {GMAX}]")
    if not all(t.is_contiguous() for t in (q, cache_k, cache_v, pos)):
        raise ValueError("decode_attention: inputs must be contiguous")
    if cache_k.data_ptr() % 16 or cache_v.data_ptr() % 16:
        raise ValueError("decode_attention: the caches must start on a "
                         "16-byte boundary (16-byte row copies)")
    if B > 65535 or KV > 65535:
        raise ValueError(f"decode_attention: B={B} and KV={KV} must be <= "
                         f"65535 (grid axes)")
    out = torch.empty_like(q)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    n_split = -(-S // SPLIT)
    part = torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32,
                       device=q.device)
    err = _lib().decode_attention_launch(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), part.data_ptr(), int(q.dtype == torch.bfloat16), B,
        S, KV, G, hd, int(bool(ring)), 1.0 / math.sqrt(hd),
        _build.stream_ptr(q.device))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


#: calls that launched the kernels (one per call on a CUDA tensor, which
#: launches the split kernel and then the combine kernel)
decode_attention.launches = 0
