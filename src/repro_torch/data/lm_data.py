"""Synthetic LM training data pipeline: seeded zipf token stream, packed into
(tokens, labels) batches, with host-side sharding hooks for multi-host runs.
Deterministic per (seed, step) so every data-parallel worker can compute its
own shard without coordination."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLMStream:
    """Zipf-distributed token stream with light Markov structure so models
    have something learnable (bigram regularities)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # sparse bigram preference table
        self._shift = rng.integers(1, cfg.vocab_size - 1)

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1):
        cfg = self.cfg
        per_host = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 97 + host_id)
        raw = rng.zipf(cfg.zipf_a, size=(per_host, cfg.seq_len + 1))
        toks = np.minimum(raw, cfg.vocab_size - 1).astype(np.int32)
        # inject learnable structure: every even position follows a fixed map
        toks[:, 2::2] = (toks[:, 1:-1:2] + self._shift) % cfg.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
