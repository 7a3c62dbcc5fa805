"""Kernel 2 (flash attention forward, forward and recomputed) against its
roofline at the step's shapes: causal operations 4 hd a kept pair a head
at 989 TFLOP/s bf16 (data sheet, 700 W), or q, k, v, o and the
log-sum-exp at 3.35 TB/s, a call, times its calls in the trace, over the
device time of the kernels so named, in %."""
from bench.metrics._read import flash_roofline_pct


def read(ctx):
    return flash_roofline_pct(ctx, backward=False)
