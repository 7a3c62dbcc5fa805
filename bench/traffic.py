"""The one traffic generator.  Every mix is a data file,
``bench/traffic/<name>.json``, whose ``kind`` says which of these the
drivers read:

- ``route_backlog``: bulk routing with a standing backlog.  A pool of
  ``text_pool`` texts, cycled; waves of ``max_batch``.
- ``route_open``: an open loop of independent users at ``rate`` routes/s
  on average, with a burst of ``burst_factor`` times the base rate for
  ``burst_s`` seconds every ``burst_period_s`` (a seeded phase).
- ``lm_train``: a seeded zipf token stream, ``batch`` x ``seq`` tokens a
  step.

Texts have ``words_median`` words on a lognormal of ``words_sigma``, cut to
``words_max``; words cluster by topic (``topics`` topics of
``topic_words`` words each, zipf ``zipf_a`` over a topic's words) with a
share ``common_share`` drawn from ``common_words`` shared ones.  Each
request carries a lambda from ``lambdas``.

So that a seed changes which texts and which order, and not how much work
a run does, every seed gets the same multiset of text lengths, lambdas and
arrival gaps (fixed quantiles of their distributions), in its own order;
the words and topics are drawn from the seed.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass

import numpy as np

from .common import sub_seed


def _rng(seed, *key):
    return np.random.default_rng(sub_seed(seed, *key))


def _normal_quantiles(n: int) -> np.ndarray:
    nd = statistics.NormalDist()
    return np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])


def text_lengths(p: dict, n: int, seed, stream: str) -> np.ndarray:
    """``n`` word counts: the lognormal's quantiles, in a seeded order."""
    z = _normal_quantiles(n)
    lens = np.rint(p["words_median"] * np.exp(p["words_sigma"] * z))
    lens = np.clip(lens, 1, p["words_max"]).astype(np.int64)
    return _rng(seed, stream, "lengths").permutation(lens)


def make_texts(p: dict, n: int, seed, stream: str):
    """(texts, topics): ``n`` topic-clustered texts of the mix."""
    lens = text_lengths(p, n, seed, stream)
    rng = _rng(seed, stream, "words")
    topics = rng.integers(0, p["topics"], size=n)
    total = int(lens.sum())
    owner = np.repeat(np.arange(n), lens)
    common = rng.random(total) < p["common_share"]
    # zipf over a topic's words: rank r (from 1) with weight r ** -zipf_a
    w = np.arange(1, p["topic_words"] + 1, dtype=np.float64) ** -p["zipf_a"]
    cdf = np.cumsum(w / w.sum())
    rank = np.minimum(np.searchsorted(cdf, rng.random(total)),
                      p["topic_words"] - 1)
    crank = rng.integers(0, p["common_words"], size=total)
    words = [f"c{c}" if is_c else f"t{t}w{r}" for is_c, c, t, r in
             zip(common.tolist(), crank.tolist(), topics[owner].tolist(),
                 rank.tolist())]
    ends = np.cumsum(lens)
    starts = ends - lens
    texts = [" ".join(words[a:b]) for a, b in zip(starts.tolist(),
                                                  ends.tolist())]
    return texts, topics


def lambdas(p: dict, n: int, seed, stream: str) -> np.ndarray:
    """Per-request lambdas: the mix's values in equal shares, seeded
    order."""
    vals = np.asarray(p["lambdas"], np.float32)
    lam = np.resize(vals, n)
    return _rng(seed, stream, "lambdas").permutation(lam)


def arrivals(p: dict, seconds: float, seed) -> np.ndarray:
    """Due times (s from the window's start) of an open loop: a unit-rate
    process with the exponential's quantiles as gaps in a seeded order,
    mapped through the bursty rate's integral.  Its count is the mean rate
    times the window, the same for every seed."""
    rate, f = float(p["rate"]), float(p["burst_factor"])
    period, burst = float(p["burst_period_s"]), float(p["burst_s"])
    base = rate * period / (period - burst + f * burst)   # mean == rate
    n = int(np.floor(rate * seconds))
    if n <= 0:
        return np.zeros(0)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps = _rng(seed, "arrivals", "gaps").permutation(gaps)
    phase = float(_rng(seed, "arrivals", "phase").uniform(0, period))
    # operational time of each arrival, scaled so the last lands inside
    # the window on average: the mean rate's integral over the window
    op = np.cumsum(gaps)
    op *= (rate * seconds) / op[-1] * (n - 0.5) / n
    return _invert_intensity(op, base, f, period, burst, phase)


def burst_intensity(t, base, f, period, burst, phase):
    """The rate at time(s) ``t``: ``base``, times ``f`` inside a burst."""
    inb = np.mod(np.asarray(t) - phase, period) < burst
    return np.where(inb, base * f, base)


def _cum_intensity(t, base, f, period, burst, phase):
    """Integral of `burst_intensity` from 0 to ``t`` (vectorised)."""
    t = np.asarray(t, np.float64)

    def from_phase(x):              # integral over [phase, phase + x]
        k = np.floor(x / period)
        r = x - k * period
        per = base * (period - burst) + base * f * burst
        return k * per + np.where(r < burst, base * f * r,
                                  base * f * burst + base * (r - burst))
    return from_phase(t + (period - phase)) - from_phase(period - phase)


def _invert_intensity(op, base, f, period, burst, phase):
    """Times at which the cumulative intensity reaches ``op`` (bisection,
    vectorised)."""
    lo = np.zeros_like(op)
    hi = op / base + period
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        below = _cum_intensity(mid, base, f, period, burst, phase) < op
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# the training stream: a frozen copy of `repro_torch.data.lm_data`
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLMStream:
    """Copied from ``repro_torch/data/lm_data.py`` (`SyntheticLMStream`):
    a zipf-distributed token stream with light Markov structure (every
    even position follows a fixed map of the one before), deterministic
    per (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._shift = rng.integers(1, cfg.vocab_size - 1)

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1):
        cfg = self.cfg
        per_host = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 97 + host_id)
        raw = rng.zipf(cfg.zipf_a, size=(per_host, cfg.seq_len + 1))
        toks = np.minimum(raw, cfg.vocab_size - 1).astype(np.int32)
        toks[:, 2::2] = (toks[:, 1:-1:2] + self._shift) % cfg.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_stream(p: dict, vocab: int, seed) -> SyntheticLMStream:
    return SyntheticLMStream(DataConfig(
        vocab_size=vocab, seq_len=int(p["seq"]), global_batch=int(p["batch"]),
        seed=sub_seed(seed, "lm_stream") % (2**31), zipf_a=float(p["zipf_a"])))
