"""The result line: its keys, the metrics of the cell under their names
and units, the device block, the breakdown of a traced run, and the
numbers compared beside their limits under the last key; and no result
at all without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT, tiny_cell

from slambench import harness


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    cell = tiny_cell("city-seq")
    res = harness.run_cell(cell, 2**31 + 5, 0.5, trace, "cpu", time.perf_counter(), log=lambda *a: None)
    assert list(res)[:3] == ["correct", "attempted", "failed"] and list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    assert res["metrics"] and all(units[k] == v["unit"] for k, v in res["metrics"].items())
    if not trace:
        assert set(res["metrics"]) == {"scans_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["window_s"] > 0 and len(res["breakdown"]["idle_gaps"]) <= 10
        assert len(res["breakdown"]["device_ops"]) <= 10
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"} and c["limit"] == cell.traffic["limits"][name]
    json.dumps(res)


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "slambench.run", "--workload", "city-seq", "--seed", str(2**31 + 9),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120, env=env,
    )


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout == "" and "CUDA card" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(tmp_path, env)
    assert p.returncode != 0 and p.stdout == ""
