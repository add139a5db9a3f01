"""Every cell, configuration, mix, limit and metric of BENCHMARK.json loads
by name, and the file keeps the contract's shape."""

import json
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = spec.Cell(cell)
    assert c.chips == 1
    assert c.mix["route"] in ("/api/simulate", "/api/grid")
    assert c.limits and all(v >= 0 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(spec.reader(metric))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"] for w in BENCH["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells) == len(BENCH["workloads"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
        with open(spec.ROOT / c["file"]) as fh:
            assert json.load(fh)["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reporting
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_the_configs_are_the_upstream_files_at_the_served_path_counts():
    for name, upstream in (("macunaima", "config.json"), ("jorge", "jorge.json")):
        with open(spec.ROOT / upstream) as fh:
            source = json.load(fh)
        cfg = spec.Cell(f"{name}.plan").config
        changed = {k for k in source if source[k] != cfg[k]}
        entry = next(c for c in BENCH["configs"] if c["name"] == name)
        assert changed == set(entry["reduced"])
        assert set(cfg) == set(source)
