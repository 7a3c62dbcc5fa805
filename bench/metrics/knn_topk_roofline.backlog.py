"""Kernel 1 (exact top-k) against its roofline: the least time of the
waves' shapes (bytes N D 4 + Q D 4 + Q k 8 at 3.35 TB/s, or 2 Q N D
operations at 494.7 / 3 TFLOP/s, f32-accurate tensor-core products; data
sheet, 700 W) over the kernel's device time in the trace, in %."""
from bench.metrics._read import knn_topk_roofline_pct


def read(ctx):
    return knn_topk_roofline_pct(ctx)
