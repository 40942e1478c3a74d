"""Shared pieces of the benchmark's own tests: each cell cut to a size the
CPU runs in seconds, with the program's plain nearest-neighbour path."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# scene and traffic overrides that keep each cell's shapes but few points
TINY = {
    "ring-graph": {
        "scene": {"n_scans": 40, "points_per_scan": 2048, "surface_samples": 60000, "floor_boxes": 30,
                  "box_points": 600, "pillar_points": 600},
        "traffic": {"sets": 1, "job_scans": 40, "warm": {"scene": {"n_scans": 20}}},
    },
    "city-seq": {
        "scene": {"n_scans": 7, "points_per_scan": 6000, "ground_points": 200000, "facade_points": 12000},
        "traffic": {"sets": 1, "job_scans": 7, "warm": {"scans": 2}, "sample": {"match": 3, "relax": 1}},
        "lum": {"chained_min": 1024},  # the host LUM, as at the cell's size
    },
}


def tiny_cell(name: str):
    from slambench import harness

    cell = harness.load_cell(name, ROOT)
    t = TINY[name]
    cell.cfg["scene"].update(t["scene"])
    cell.traffic.update(t["traffic"])
    for k in ("icp", "lum"):
        cell.cfg[k].update(t.get(k, {}))
    return cell


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Test processes run side by side: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
