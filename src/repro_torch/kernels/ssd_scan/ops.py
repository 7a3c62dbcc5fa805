"""Mamba-2 SSD scan of the port (mirrors `repro.kernels.ssd_scan.ops`):
the intra-chunk pass is kernel 6 (`kernel.cu`, replacing
`ssd_intra_pallas`), its gradient a second kernel (`bwd_kernel.cu`), and
the inter-chunk recurrence plain torch ops that autograd differentiates.

``ssd_intra`` is a `torch.autograd.Function`: on CUDA tensors its forward
launches kernel 6 and its backward the gradient kernels; on CPU tensors
both take their plain versions (`ref.ssd_intra_plain`,
`ref.ssd_intra_bwd_plain`).  There is no fallback on the card: a CUDA
tensor the kernels cannot take raises.  Each call launches several CUDA
kernels (C B^T once per group, then the heads' passes) into scratch of
`pair_scratch_shape`; the launch counters count calls.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssd_intra_bwd_plain, ssd_intra_plain

QMAX = 256     # ssd_common.cuh: QMAX, the longest chunk
PMAX = 64      # PMAX, the widest head
NMAX = 128     # NMAX, the largest state
TQ = 64        # TQ, the rows of a tile
_GRID_MAX = 65535


def pair_scratch_shape(Bs, G, nc, Q):
    """The kernels' per-group scratch: one 64 x 64 f32 tile for each causal
    pair (i >= j) of a chunk's row tiles, (B, G, nc, pairs, 64, 64).  It
    holds C B^T (forward and gradient) and the sum of gG over a group's
    heads (gradient)."""
    nt = -(-Q // TQ)
    return (Bs, G, nc, nt * (nt + 1) // 2, TQ, TQ)


def _fn(name, symbol, n_ptrs):
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
    return fn


def _check(x, dt, A, Bm, Cm):
    if x.ndim != 5 or dt.shape != x.shape[:4] + (1,) or A.ndim != 1 \
            or Bm.ndim != 5 or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_intra: x (B,H,nc,Q,P), dt (B,H,nc,Q,1), A (H,)"
                         f" and B/C (B,G,nc,Q,N) expected, got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    Bs, H, nc, Q, _ = x.shape
    G = Bm.shape[1]
    if A.shape[0] != H or Bm.shape[0] != Bs or Bm.shape[2:4] != (nc, Q) \
            or G < 1 or H % G:
        raise ValueError(f"ssd_intra: inconsistent shapes x "
                         f"{tuple(x.shape)}, A {tuple(A.shape)}, B/C "
                         f"{tuple(Bm.shape)} (H must be a multiple of G)")
    devs = {t.device for t in (x, dt, A, Bm, Cm)}
    if len(devs) != 1:
        raise ValueError(f"ssd_intra: inputs on different devices {devs}")
    return devs.pop()


def _kernel_args(dev, *ts):
    if dev.type != "cuda":
        raise ValueError(f"ssd_intra: unsupported device {dev}")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_intra: f32 inputs expected, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("ssd_intra: inputs must be contiguous")


def _dims(x, Bm):
    Bs, H, nc, Q, P = x.shape
    G, N = Bm.shape[1], Bm.shape[4]
    if not (1 <= Q <= QMAX and 1 <= P <= PMAX and 1 <= N <= NMAX):
        raise ValueError(f"ssd_intra: the kernels take chunks Q <= {QMAX}, "
                         f"heads P <= {PMAX} and states N <= {NMAX}; got "
                         f"Q={Q}, P={P}, N={N}")
    if nc * -(-Q // TQ) > _GRID_MAX or Bs * G > _GRID_MAX \
            or H > _GRID_MAX or Bs > _GRID_MAX:
        raise ValueError(f"ssd_intra: B, H, B G and nc x (row tiles) must "
                         f"be <= {_GRID_MAX}")
    return Bs, H, nc, Q, P, G, N


def ssd_intra_fwd(x, dt, A, Bm, Cm):
    """Kernel 6's function without autograd: (y_intra, states, cs).  CPU
    tensors take `ssd_intra_plain`; CUDA tensors launch `kernel.cu`."""
    dev = _check(x, dt, A, Bm, Cm)
    if dev.type == "cpu":
        return ssd_intra_plain(x, dt, A, Bm, Cm)
    _kernel_args(dev, x, dt, A, Bm, Cm)
    Bs, H, nc, Q, P, G, N = _dims(x, Bm)
    y = torch.empty_like(x)
    st = torch.empty((Bs, H, nc, P, N), dtype=torch.float32, device=dev)
    cs = torch.empty_like(dt)
    cb = torch.empty(pair_scratch_shape(Bs, G, nc, Q), dtype=torch.float32,
                     device=dev)
    err = _fn("ssd_intra", "ssd_intra_launch", 9)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), st.data_ptr(), cs.data_ptr(),
        cb.data_ptr(), Bs, H, nc, Q, P, G, N, _build.stream_ptr(dev))
    _build.check(err, "ssd_intra")
    ssd_intra.launches += 1
    return y, st, cs


def ssd_intra_bwd(x, dt, A, Bm, Cm, cs, gy, gst, gcs):
    """Gradient of kernel 6's function: (gx, gdt, gA, gB, gC) in the
    inputs' shapes (formulas in `ref.ssd_intra_bwd_plain`).  CPU tensors
    take the plain version; CUDA tensors launch `bwd_kernel.cu`, which
    sums gB / gC over a group's heads itself and writes per-block f64 gA
    that this wrapper sums."""
    dev = _check(x, dt, A, Bm, Cm)
    if dev.type == "cpu":
        return ssd_intra_bwd_plain(x, dt, A, Bm, Cm, cs, gy, gst, gcs)
    _kernel_args(dev, x, dt, A, Bm, Cm, cs, gy, gst, gcs)
    Bs, H, nc, Q, P, G, N = _dims(x, Bm)
    if cs.shape != dt.shape or gy.shape != x.shape \
            or gst.shape != (Bs, H, nc, P, N) or gcs.shape != dt.shape:
        raise ValueError("ssd_intra_bwd: gradient shapes differ from the "
                         "forward outputs'")
    gx = torch.empty_like(x)
    gdt = torch.empty_like(dt)
    gA_blk = torch.empty((Bs, H, nc), dtype=torch.float64, device=dev)
    gB = torch.empty_like(Bm)
    gC = torch.empty_like(Cm)
    cb, gsum = (torch.empty(pair_scratch_shape(Bs, G, nc, Q),
                            dtype=torch.float32, device=dev)
                for _ in range(2))
    err = _fn("ssd_intra_bwd", "ssd_intra_bwd_launch", 16)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), cs.data_ptr(), gy.data_ptr(), gst.data_ptr(),
        gcs.data_ptr(), gx.data_ptr(), gdt.data_ptr(), gA_blk.data_ptr(),
        gB.data_ptr(), gC.data_ptr(), cb.data_ptr(), gsum.data_ptr(),
        Bs, H, nc, Q, P, G, N, _build.stream_ptr(dev))
    _build.check(err, "ssd_intra_bwd")
    ssd_intra_bwd.launches += 1
    return gx, gdt, gA_blk.sum((0, 2)).float(), gB, gC


class _SSDIntra(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        y, st, cs = ssd_intra_fwd(x, dt, A, Bm, Cm)
        ctx.save_for_backward(x, dt, A, Bm, Cm, cs)
        return y, st, cs

    @staticmethod
    def backward(ctx, gy, gst, gcs):
        # autograd materialises the gradient of an unused output as zeros
        x, dt, A, Bm, Cm, cs = ctx.saved_tensors
        return ssd_intra_bwd(x, dt, A, Bm, Cm, cs, gy.contiguous(),
                             gst.contiguous(), gcs.contiguous())


def ssd_intra(x, dt, A, Bm, Cm):
    """Differentiable kernel 6: x (B,H,nc,Q,P), dt (B,H,nc,Q,1), A (H,),
    Bm / Cm (B,G,nc,Q,N), all f32 -> (y_intra (B,H,nc,Q,P),
    states (B,H,nc,P,N), cs (B,H,nc,Q,1))."""
    return _SSDIntra.apply(x, dt, A, Bm, Cm)


#: forward calls on CUDA tensors (one per call, whatever the CUDA launches
#: inside: the wrapper `ssd_intra_fwd` counts them, through autograd or not)
ssd_intra.launches = 0
#: backward calls on CUDA tensors (one per call)
ssd_intra_bwd.launches = 0


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, initial_state=None):
    """Same contract as `ref.ssd_reference`: x (B,S,H,P), dt (B,S,H),
    A (H,), Bm / Cm (B,S,G,N) -> (y (B,S,H,P) f32, final_state (B,H,P,N)
    f32).  S must be a multiple of ``chunk``."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    assert nc * chunk == S, f"seq {S} not divisible by chunk {chunk}"
    f32 = torch.float32
    xr = x.to(f32).reshape(B_, nc, chunk, H, P).permute(0, 3, 1, 2, 4)
    dtr = dt.to(f32).reshape(B_, nc, chunk, H).permute(0, 3, 1, 2)[..., None]
    Br = Bm.to(f32).reshape(B_, nc, chunk, G, N).permute(0, 3, 1, 2, 4)
    Cr = Cm.to(f32).reshape(B_, nc, chunk, G, N).permute(0, 3, 1, 2, 4)
    y_intra, states, cs = ssd_intra(
        xr.contiguous(), dtr.contiguous(), A.to(f32).contiguous(),
        Br.contiguous(), Cr.contiguous())

    cs = cs[..., 0]                                   # (B,H,nc,Q)
    chunk_decay = torch.exp(cs[..., -1])              # (B,H,nc)
    h = (x.new_zeros((B_, H, P, N), dtype=f32) if initial_state is None
         else initial_state.to(f32))
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, :, c]
    h_starts = torch.stack(starts, 2)                 # (B,H,nc,P,N)
    grp = torch.arange(H, device=x.device) * G // H
    Ch = Cr.index_select(1, grp)                      # (B,H,nc,Q,N)
    y_inter = torch.einsum("bhcqn,bhcpn,bhcq->bhcqp", Ch, h_starts,
                           torch.exp(cs))
    y = (y_intra + y_inter).permute(0, 2, 3, 1, 4).reshape(B_, S, H, P)
    return y, h
