"""The kernel wrappers on fake tensors (``FakeTensorMode``), for the
model-side dry-run (`launch.dryrun`): a wrapper given a fake tensor
allocates what its CUDA path allocates (outputs, the log-sum-exp and f32
output it keeps for the backward, its scratch) instead of running the
plain version, whose f32 (B, H, Sq, Sk) scores are not what the card
holds, and reports the matrix-product FLOPs its kernel does to every
active sink (`launch.cost_analysis.measure` opens one), since
``FlopCounterMode`` sees no kernel.  Real tensors never take this path.
"""
from __future__ import annotations

import functools
from typing import List

import numpy as np

#: lists that `report` appends (kernel name, FLOPs) to, one per active
#: measurement
SINKS: List[list] = []


@functools.lru_cache(maxsize=None)
def _fake_class():
    from torch._subclasses.fake_tensor import FakeTensor
    return FakeTensor


def is_fake(t) -> bool:
    return isinstance(t, _fake_class())


def report(name: str, flops: float) -> None:
    for sink in SINKS:
        sink.append((name, float(flops)))


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention mask keeps (`flash_attention`'s
    mask, query i against key j: j <= i when causal, i - j < window when
    windowed)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Sk) if causal else np.full(Sq, Sk, np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())
