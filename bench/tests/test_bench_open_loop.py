"""The open loop of the route driver (``kind: route_open``; the mix
``traffic/open.json``, whose cell PERF.md keeps for later): every request
due in the window is answered and judged, and the tail is the tail of all
of them, each timed from its due time."""
from types import SimpleNamespace

import numpy as np

from bench import common
from bench.tests.conftest import SMALL


def _cell(seed):
    man = common.manifest()
    cfg = common.config(man, "knn100-exact-1m")
    cfg.update(SMALL["knn100-exact-1m"])
    tp = common.traffic("open")
    tp.update(SMALL["open"])
    drv = common.driver(cfg["driver"])
    return drv.Cell(SimpleNamespace(
        config_name="knn100-exact-1m", cfg=cfg, traffic_name="open",
        traffic=tp, seed=seed, device="cpu", workload="open-loop-test"))


def test_p95_over_all_requests_from_due_time():
    cell = _cell(2**32 + 9)
    cell.setup()
    out = cell.run_window(2.0)
    due = cell.due
    assert cell.attempted == len(due) == int(cell.tp["rate"] * 2.0)
    assert cell.failed == 0
    lat = cell.latency_ms
    assert len(lat) == len(due) and np.isfinite(lat).all()
    # each latency runs from the due time to the end of the answering wave
    waves_end = {tk: w["t"] for w in cell.waves for tk in w["tickets"]}
    got = np.array([waves_end[tk] for tk in sorted(cell.req,
                                                    key=cell.req.get)])
    assert np.allclose(lat, (got - due) * 1e3)
    assert (lat > 0).all()
    assert out["route_p95_ms"] == np.percentile(lat, 95)
    # a request never answered would count as missing any latency limit
    assert cell.answered == cell.attempted
    cell.release()
    lim = common.limits("route.knn100-1m.open")
    readings = cell.check(lim)
    assert all(readings[n] <= lim[n] for n in common.driver("route").CHECKS)

