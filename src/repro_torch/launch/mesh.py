"""The card's constants for the port's roofline reckoning (the counterpart
of `repro.launch.mesh`, whose TPU v5e numbers do not carry over).

Only the one card the port is measured on, for now: an NVIDIA H100 SXM
(``nvidia-smi`` names it "NVIDIA H100 80GB HBM3"; the port's chip runs
read its power limit as 700.00 W).  The numbers are NVIDIA's H100 SXM
data-sheet peaks.  `chip_smoke.bound` and `kernels.knn_ivf.autotune.
roofline_terms` divide a kernel's bytes and operations by them.  The mesh
constructors of the distributed paths come with the slice that ports them.
"""
from __future__ import annotations

#: the card the peaks below are for, as ``nvidia-smi --query-gpu=
#: name,power.limit`` prints it (`chip_smoke.py` records whether the card
#: it runs on is this one)
CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT = "700.00 W"

#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: dense tensor-core peaks, FLOP/s.  f32 is the rate of f32-accurate
#: products on the tensor cores: three TF32 passes a product (big x small +
#: small x big + big x big, ssd_common.cuh) at 494.7 TFLOP/s TF32, 2.5x the
#: 67 TFLOP/s of the FMA units
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 494.7e12 / 3
PEAK_FLOPS = {"float32": PEAK_FLOPS_F32, "bfloat16": PEAK_FLOPS_BF16}
