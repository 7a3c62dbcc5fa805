"""Kernel 2b (flash attention backward: its D, dQ / dK-dV and sum
launches) against its roofline at the step's shapes: 10 hd operations a
kept pair a head at 989 TFLOP/s bf16 (data sheet, 700 W), or its inputs
and outputs at 3.35 TB/s, a call, times its calls in the trace, over the
device time of the kernels so named, in %."""
from bench.metrics._read import flash_roofline_pct


def read(ctx):
    return flash_roofline_pct(ctx, backward=True)
