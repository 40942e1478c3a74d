"""A run with the timed path broken underneath comes out not correct:
for each fault a cell can have, the program is patched where the fault
would sit and a whole run (set-up, window, comparison) is driven on the
CPU at a tiny size, past the harness's look for a card.

- a step that returns its state unchanged: an ICP match, an ELCH
  closure, a device or a host LUM iteration that leaves the poses, the
  later iterations of a relaxation that leave them, a relaxation that
  stops after its first iteration;
- half of the batch left out: each scan's reduction keeps half of its
  points;
- an answer altered where it is produced: an ICP match's pose moved by
  2 cm.

One chip has no exchange between chips to leave out."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from conftest import tiny_cell

from slambench import harness
from tpu3dtk_torch.models import elch, icp, lum_device
from tpu3dtk_torch.ops import reduction


def _run(name, seed=2**31 + 21):
    cell = tiny_cell(name)
    cell.traffic["warm"] = {"scans": 2}
    return harness.run_cell(cell, seed, 0.0, False, "cpu", time.perf_counter(), log=lambda *a: None)


def _icp_unchanged(monkeypatch):
    def unchanged(model, mmask, target_local, tmask, T0, **kw):
        T = torch.as_tensor(T0, dtype=torch.float32, device=model.device)
        return icp.IcpResult(T=T, error=0.0, iterations=1, n_pairs=float(tmask.sum()))

    monkeypatch.setattr(icp, "icp_pair", unchanged)


def _icp_altered(monkeypatch):
    real = icp.icp_pair

    def altered(*a, **kw):
        res = real(*a, **kw)
        T = res.T.clone()
        T[0, 3] += 2.0
        return res._replace(T=T)

    monkeypatch.setattr(icp, "icp_pair", altered)


def _half_batch(monkeypatch):
    real = reduction.reduce_scan

    def half(xyz, *a, **kw):
        return real(np.asarray(xyz)[: len(xyz) // 2], *a, **kw)

    monkeypatch.setattr(reduction, "reduce_scan", half)


def _elch_unchanged(monkeypatch):
    def unchanged(scans, first, last, graph_edges, params):
        for s in scans[1:]:
            s.transform(np.eye(4), elch.AlgoType.ELCH, record=True)
        scans[0].add_frame(elch.AlgoType.ELCH)

    monkeypatch.setitem(elch.ELCH_VARIANTS, 4, unchanged)


def _lum_unchanged(monkeypatch):
    def step(locals_pts, masks, links, link_mask, pos0, theta0, *a, **kw):
        return np.array(pos0, np.float64), np.array(theta0, np.float64), 0.0

    def run(locals_pts, masks, links, link_mask, pos0, theta0, *a, on_iteration=None, **kw):
        pos, theta = np.array(pos0, np.float64), np.array(theta0, np.float64)
        if on_iteration is not None:
            on_iteration(pos, theta)
        return pos, theta, 1, 0.0

    monkeypatch.setattr(lum_device, "lum_step_cached", step)
    monkeypatch.setattr(lum_device, "lum_run", run)


def _lum_later_unchanged(monkeypatch):
    real = lum_device.lum_run

    def run(*a, iterations, on_iteration=None, **kw):
        pos, theta, _n, ret = real(*a, iterations=1, on_iteration=on_iteration, **kw)
        for _ in range(1, iterations):
            if on_iteration is not None:
                on_iteration(pos, theta)
        return pos, theta, iterations, ret

    monkeypatch.setattr(lum_device, "lum_run", run)


def _lum_stops_early(monkeypatch):
    real = lum_device.lum_run

    def run(*a, iterations, **kw):
        return real(*a, iterations=1, **kw)

    monkeypatch.setattr(lum_device, "lum_run", run)


def _host_lum_unchanged(monkeypatch):
    from tpu3dtk_torch.models import graphslam

    def unchanged(scans, links, params):
        for s in scans[1:]:
            s.set_pose(s.transMat, graphslam.AlgoType.LUM)
        scans[0].add_frame(graphslam.AlgoType.LUM)
        return 0.0

    monkeypatch.setattr(graphslam, "_do_graph_slam_host", unchanged)


CASES = [
    ("ring-graph", _icp_unchanged, "icp_gap_cm"),
    ("ring-graph", _icp_altered, "icp_gap_cm"),
    ("city-seq", _half_batch, "reduce_rows_differ"),
    ("ring-graph", _elch_unchanged, "elch_gap_cm"),
    ("ring-graph", _lum_unchanged, "lum_gap_cm"),
    ("ring-graph", _lum_later_unchanged, "lum_gap_cm"),
    ("ring-graph", _lum_stops_early, "lum_gap_cm"),
    ("city-seq", _host_lum_unchanged, "lum_gap_cm"),
]


def test_sound_run_is_correct():
    assert _run("ring-graph")["correct"] is True


@pytest.mark.parametrize("name,fault,number", CASES, ids=lambda x: getattr(x, "__name__", x))
def test_fault_makes_the_run_incorrect(monkeypatch, name, fault, number):
    fault(monkeypatch)
    res = _run(name)
    c = res["checks"][number]
    assert res["correct"] is False and (c["value"] is None or c["value"] > c["limit"]), res["checks"]
