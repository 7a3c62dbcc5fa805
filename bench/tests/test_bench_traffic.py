"""The traffic generator: deterministic per seed, the same work for every
seed, and the burst schedule at its stated mean rate."""
import numpy as np
import pytest

from bench import common
from bench import traffic as T


@pytest.mark.parametrize("mix", ["backlog", "open"])
def test_texts_deterministic_per_seed(mix):
    p = common.traffic(mix)
    a = T.make_texts(p, 500, 2**33 + 5, "requests")
    b = T.make_texts(p, 500, 2**33 + 5, "requests")
    c = T.make_texts(p, 500, 2**33 + 6, "requests")
    assert a[0] == b[0] and (a[1] == b[1]).all()
    assert a[0] != c[0]


def test_every_seed_the_same_work():
    p = common.traffic("open")
    la = T.text_lengths(p, 4000, 1, "requests")
    lb = T.text_lengths(p, 4000, 2, "requests")
    assert sorted(la) == sorted(lb) and list(la) != list(lb)
    assert la.max() <= p["words_max"] and la.min() >= 1
    assert 11 <= np.median(la) <= 13
    lam_a = T.lambdas(p, 4000, 1, "requests")
    lam_b = T.lambdas(p, 4000, 2, "requests")
    assert sorted(lam_a) == sorted(lam_b)
    assert {float(x) for x in lam_a} == set(p["lambdas"])
    ga = np.diff(T.arrivals(p, 20, 1))
    assert len(T.arrivals(p, 20, 1)) == len(T.arrivals(p, 20, 2)) \
        == int(p["rate"] * 20)
    assert len(ga) > 0


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_burst_schedule_mean_rate(seed):
    p = common.traffic("open")
    secs = 4 * p["burst_period_s"]
    due = T.arrivals(p, secs, seed)
    assert np.all(np.diff(due) >= 0) and due[0] >= 0 and due[-1] < secs
    assert len(due) / secs == pytest.approx(p["rate"], rel=1e-3)
    # inside bursts the rate is burst_factor times the rate outside
    period, burst = p["burst_period_s"], p["burst_s"]
    base = p["rate"] * period / (period - burst + p["burst_factor"] * burst)
    phase = [t for t in np.arange(0, period, 0.001)
             if T.burst_intensity(t, base, p["burst_factor"], period, burst,
                                  float(T._rng(seed, "arrivals", "phase")
                                        .uniform(0, period))) > base][0]
    inb = np.mod(due - phase, period) < burst
    r_in = inb.sum() / (4 * burst)
    r_out = (~inb).sum() / (secs - 4 * burst)
    assert r_in / r_out == pytest.approx(p["burst_factor"], rel=0.1)


def test_lm_stream_copy_matches_the_port():
    from repro_torch.data.lm_data import DataConfig, SyntheticLMStream
    cfg = dict(vocab_size=32000, seq_len=64, global_batch=2, seed=7)
    a = T.SyntheticLMStream(T.DataConfig(**cfg)).batch(3)
    b = SyntheticLMStream(DataConfig(**cfg)).batch(3)
    assert all((a[k] == b[k]).all() for k in ("tokens", "labels"))
