"""``BENCHMARK.json`` against the benchmark's contract, and every
workload's files found by name."""

import json
import re

import pytest

from tiny_cell import REPO
from motifbench import harness

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["motifbench"]
    assert SPEC["command"][1] == "motifbench/run.py"
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(SPEC["workloads"])
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, cells // 4)


def test_names_units_and_texts():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for c in SPEC["configs"]:
        assert 1 <= len(c["source"]) <= 200 and c["reduced"] == []
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for w in WORKLOADS:
        have = [m for m in e2e.values() if w in m.get("workloads", WORKLOADS)]
        assert "setup_s" in [m["name"] for m in have] and len(have) >= 2


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", WORKLOADS)
        if m["name"].endswith("_roofline") or m["name"].endswith("roofline_pct"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_files_resolve_by_name(workload):
    c = harness.cell(REPO, workload)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["name"] == c.entry["traffic"]
    assert set(c.limits) == set(harness.check.NAMES)
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))
    conf = next(x for x in SPEC["configs"] if x["name"] == c.entry["config"])
    assert conf["file"].startswith("motifbench/configs/")
