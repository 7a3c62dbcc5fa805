"""BENCHMARK.json against the contract's forms, and every file the
harness finds by name."""
import json
import re

from bench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_lines():
    man = common.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    for c in man["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    for w in man["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"]) \
            and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in man["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(man)) < 64 * 1024


def test_every_file_found_by_name():
    man = common.manifest()
    for w in man["workloads"]:
        cfg = common.config(man, w["config"])
        assert (common.BENCH / "configs" / cfg["reference"]).exists()
        assert (common.BENCH / "drivers" / f"{cfg['driver']}.py").exists()
        assert common.traffic(w["traffic"])["kind"]
        lim = common.limits(w["name"])
        drv = common.driver(cfg["driver"])
        assert set(drv.CHECKS) <= set(lim), w["name"]
    for m in man["per_layer"]:
        assert hasattr(common.metric_reader(m["name"]), "read")


def test_every_cell_reports_what_its_metrics_move():
    man = common.manifest()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        mine = {n for n, m in e2e.items()
                if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in man["per_layer"]
                 if w["name"] in m.get("workloads", [])]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])


def test_roofline_and_mfu_names():
    man = common.manifest()
    for m in man["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
