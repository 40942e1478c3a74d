"""The cells load as data: BENCHMARK.json keeps to its schema, and every
configuration, traffic file, generator, entry and metric reader a cell
names is found by that name."""

from __future__ import annotations

import importlib
import json
import re

import pytest
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slambench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


def test_names_units_and_lines():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("slambench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    texts = [c["source"] for c in BENCH["configs"]] + [x["why"] for x in BENCH["configs"] + BENCH["workloads"]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())


def test_per_layer_metrics_have_readers_and_cells():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert callable(importlib.import_module(f"slambench.metrics.{m['name']}").read)
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    from slambench import harness

    cell = harness.load_cell(name, ROOT)
    assert importlib.import_module(f"slambench.gen.{cell.cfg['generator']}").generate
    assert importlib.import_module(f"slambench.entries.{cell.traffic['entry']}").run
    assert {m["name"] for m in cell.end_to_end} == {"scans_per_s", "setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    plan = harness.job_plan(cell.traffic, int(cell.cfg["scene"]["n_scans"]))
    assert plan and all(len(idx) == cell.traffic["job_scans"] for _s, idx in plan)
    assert "reduce_rows_differ" in cell.traffic["limits"]
    assert any(k.startswith("icp_gap") for k in cell.traffic["limits"])
    assert cell.traffic["limits"]["reduce_rows_differ"] == 0


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_reduced_keys_name_changed_values(conf):
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        group, k = key.split(".")
        assert k in cfg[group]
        if "source_values" in cfg:
            assert cfg["source_values"][key] != cfg[group][k]
