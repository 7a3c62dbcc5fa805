"""Wrappers of the forward attention kernel (`kernel.cu`) and its backward
(`bwd_kernel.cu`); `flash_attention` replaces
`repro.kernels.flash_attention.ops.flash_attention`.

Model layout in and out: q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk,
KV, dv) -> (B, Sq, H, dv) in q.dtype, dv = hd but for MLA's pair (hd 192,
dv 128, bf16 on the card, `MLA_DIMS`); scores scaled by ``scale``
(1/sqrt(hd) unless the caller gives one: MLA's YaRN scale).  CPU tensors take the plain versions (`ref.py`,
differentiated by autograd); CUDA tensors launch the kernels or raise: f32
inputs the forward kernel on the FMA units, bf16 inputs the one on the
tensor cores (`kernel.cu`, chosen there by the dtype).  On
the card, where a gradient is wanted (grad mode on and an input that
requires it, also inside `torch.utils.checkpoint`), `flash_attention` is a
`torch.autograd.Function`: its forward launches the forward kernel, which
also writes each row's log-sum-exp and (for bf16) the output in f32, and
its backward launches the backward kernels (`flash_attention_bwd`), which
recompute P from the log-sum-exp and take D = rowsum(dO o O) from the f32
output, as the reference differentiates through its f32 output.  Fake
tensors (the dry-run) allocate what the CUDA path allocates and report the
kernels' FLOPs (`kernels.fake`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, fake
from .ref import flash_attention_bwd_plain, flash_attention_reference

HEAD_DIMS = (64, 80, 112, 128)
#: (query / key, value) head dims of a pair the kernels take in bf16 only
MLA_DIMS = ((192, 128),)
DTYPES = (torch.float32, torch.bfloat16)


def _fn(name, symbol, n_ptrs, n_ints=10):
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def kv_splits(B, Sk, KV, G, sms):
    """Blocks the dK / dV pass splits a KV head's G query heads over: it
    has ceil(Sk / 64) KV B blocks, and under two a streaming multiprocessor
    (``sms`` of them) the heads are shared out over up to G blocks, whose
    f32 partials a third launch adds in a fixed order."""
    base = -(-Sk // 64) * KV * B
    return max(1, min(G, -(-2 * sms // base)))


def _check(q, k, v, what):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or k.shape[:3] != v.shape[:3] \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"{what}: q (B, Sq, H, hd), k (B, Sk, KV, hd) and "
                         f"v (B, Sk, KV, dv) with KV | H expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q, k, v on different devices")
    return q.device


def _check_cuda(what, *ts):
    q, v = ts[0], ts[2]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{what}: f32 or bf16 tensors of one dtype "
                        f"expected, got {[t.dtype for t in ts]}")
    dims = (q.shape[3], v.shape[3])
    if dims[0] == dims[1]:
        if dims[0] not in HEAD_DIMS:
            raise ValueError(f"{what}: head_dim {dims[0]} not in "
                             f"{HEAD_DIMS}")
    elif dims not in MLA_DIMS or q.dtype != torch.bfloat16:
        raise ValueError(f"{what}: (head_dim, v head_dim) {dims} not in "
                         f"{MLA_DIMS} in bf16")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: inputs must start on a 16-byte boundary "
                         f"(16-byte row copies)")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError(f"{what}: B={q.shape[0]} and H={q.shape[2]} must "
                         f"be <= 65535 (grid axes)")


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)


def _forward(q, k, v, causal, window, for_backward, scale=None):
    """Launch the forward kernel.  Returns (out, lse, out32): with
    ``for_backward`` the rows' log-sum-exp (B, H, Sq) and the output in f32
    (``out`` itself for f32 inputs), else None and None."""
    B, Sq, H, hd = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    if fake.is_fake(q):
        return _fake_forward(q, k, v, causal, window, for_backward)
    _check_cuda("flash_attention", q, k, v)
    out = q.new_empty((B, Sq, H, dv))
    lse = out32 = o32 = None
    if for_backward:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out32 = out if q.dtype == torch.float32 else torch.empty_like(
            out, dtype=torch.float32)
        o32 = None if out32 is out else out32.data_ptr()
    if out.numel() == 0:
        return out, lse, out32
    err = _fn("flash_attention", "flash_attention_launch", 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if for_backward else None, o32,
        int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KV, hd, dv,
        int(causal), int(window or 0), _scale(q, scale),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention.tc_launches += 1
    return out, lse, out32


def _fake_forward(q, k, v, causal, window, for_backward):
    """`_forward` on fake tensors (`kernels.fake`): the same outputs
    allocated, and 2 (hd + dv) FLOPs a kept (query, key) pair a head
    reported."""
    B, Sq, H, hd = q.shape
    dv = v.shape[3]
    fake.report("flash_attention", 2 * (hd + dv) * B * H
                * fake.attention_pairs(Sq, k.shape[1], causal, window or 0))
    out = q.new_empty((B, Sq, H, dv))
    if not for_backward:
        return out, None, None
    lse = q.new_empty((B, H, Sq), dtype=torch.float32)
    out32 = out if q.dtype == torch.float32 else torch.empty_like(
        out, dtype=torch.float32)
    return out, lse, out32


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse, out32 = _forward(q, k, v, causal, window, True, scale)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, do.contiguous(),
                                         causal=causal, window=window,
                                         out=out, lse=lse, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B, Sk, KV, dv)."""
    if _check(q, k, v, "flash_attention").type == "cpu" \
            and not fake.is_fake(q):
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, False, scale)[0]


def flash_attention_bwd(q, k, v, do, *, causal=True, window=0, out=None,
                        lse=None, scale=None):
    """(dq, dk, dv) of `flash_attention` at (q, k, v) for the output
    gradient ``do`` (B, Sq, H, dv), in the inputs' dtypes.  On the card
    ``out`` (B, Sq, H, dv) and ``lse`` (B, H, Sq), both f32, are the
    forward's (`_FlashAttention` passes them); the plain version on the CPU
    recomputes them."""
    if fake.is_fake(q):
        B, Sq, H, hd = q.shape
        fake.report("flash_attention_bwd", (6 * hd + 4 * v.shape[3]) * B * H
                    * fake.attention_pairs(Sq, k.shape[1], causal,
                                           window or 0))
        q.new_empty((B, H, Sq), dtype=torch.float32)    # delta
        return tuple(torch.empty_like(t) for t in (q, k, v))
    if _check(q, k, v, "flash_attention_bwd").type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, causal=causal,
                                         window=window, scale=scale)
    if out is None or lse is None:
        raise ValueError("flash_attention_bwd: the forward's out and lse are "
                         "needed on the card")
    _check_cuda("flash_attention_bwd", q, k, v, do)
    B, Sq, H, hd = q.shape
    Sk, KV, vd = k.shape[1], k.shape[2], v.shape[3]
    if do.shape != (B, Sq, H, vd) or out.shape != do.shape \
            or lse.shape != (B, H, Sq) or out.dtype != torch.float32 \
            or lse.dtype != torch.float32 or not out.is_contiguous() \
            or not lse.is_contiguous() or out.data_ptr() % 16:
        raise ValueError("flash_attention_bwd: do (B, Sq, H, dv) and the "
                         "forward's f32 contiguous out (B, Sq, H, dv) and "
                         "lse (B, H, Sq) expected")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # MLA's pair (vd != hd) runs one split: its partials are not laid out
    splits = 1 if vd != hd else kv_splits(
        B, Sk, KV, H // KV,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    part = None if splits == 1 else torch.empty(
        (splits, 2, B, Sk, KV, hd), dtype=torch.float32, device=q.device)
    err = _fn("flash_attention_bwd", "flash_attention_bwd_launch", 11, 11)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(),
        None if part is None else part.data_ptr(),
        int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KV, hd, vd,
        int(causal), int(window or 0), splits, _scale(q, scale),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


#: forward kernel launches through `flash_attention` (one per call on a
#: CUDA tensor, also inside the autograd Function)
flash_attention.launches = 0
#: of those, the bf16 ones: `kernel.cu`'s tensor-core kernel
#: (`flash_fwd_kernel_tc`); f32 inputs launch the FMA kernel
flash_attention.tc_launches = 0
#: calls that launched the backward kernels (each launches the delta kernel
#: and the dQ / dK-dV kernel, and the partials' sum where `kv_splits` > 1)
flash_attention_bwd.launches = 0
