"""Wrapper of the forward attention kernel (`kernel.cu`); replaces
`repro.kernels.flash_attention.ops.flash_attention`.

Model layout in and out: q (B, Sq, H, hd), k / v (B, Sk, KV, hd) ->
(B, Sq, H, hd) in q.dtype.  CPU tensors take the plain version (`ref.py`);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import flash_attention_reference

HEAD_DIMS = (64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd)."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q (B, Sq, H, hd) and k/v "
                         f"(B, Sk, KV, hd) with KV | H expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: f32 or bf16 q/k/v of one dtype "
                        f"expected, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: q, k, v must start on a 16-byte "
                         "boundary (16-byte row copies)")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: B={B} and H={H} must be <= 65535 "
                         f"(grid axes)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KV, hd, int(causal),
        int(window or 0), 1.0 / math.sqrt(hd), _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


#: kernel launches through this wrapper (one per call on a CUDA tensor)
flash_attention.launches = 0
