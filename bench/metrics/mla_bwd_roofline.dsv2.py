"""Kernel 2b at MLA's (192, 128) pair (its delta and dQ / dK-dV launches)
against its roofline at the step's shapes: 6 dk + 4 dv operations a kept
pair a head at 989 TFLOP/s bf16 (data sheet, 700 W), or its bytes at 3.35
TB/s, a call, times its calls in the trace, over the device time of the
kernels so named, in %."""
from bench.metrics._dsv2 import mla_roofline_pct


def read(ctx):
    return mla_roofline_pct(ctx, backward=True)
