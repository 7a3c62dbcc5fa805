"""The route step's share of the card's peak: the operations of the
window's waves (the encoder at all 64 positions from the configuration's
shapes, plus 2 Q N D of retrieval) over the window at 494.7 / 3 TFLOP/s
(f32-accurate tensor-core products; data sheet, 700 W), in %."""
from bench.metrics._read import route_mfu_pct


def read(ctx):
    return route_mfu_pct(ctx)
