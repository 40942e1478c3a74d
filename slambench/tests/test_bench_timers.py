"""The readers of the program's own timers on hand-made job records:
each timer's share of the jobs' wall time, or its time a scan; a reader
leaves its metric out where the program records no such timer."""

from __future__ import annotations

import pytest

from slambench.metrics import cell_list_spec_share_pct, lum_relax_share_pct, on_demand_reduction_ms_per_scan


def _ctx(timers):
    recs = [{"n_scans": 13, "wall_s": 5.0, "timers": dict(timers)},
            {"n_scans": 13, "wall_s": 5.0, "timers": dict(timers)}]
    return {"records": recs, "cfg": {}, "traffic": {}}


def test_timer_readers():
    ctx = _ctx({"cell_list_spec_time": 0.75, "lum_relax_time": 1.25, "on_demand_reduction_time": 0.39})
    assert cell_list_spec_share_pct.read(ctx) == pytest.approx(15.0)
    assert lum_relax_share_pct.read(ctx) == pytest.approx(25.0)
    assert on_demand_reduction_ms_per_scan.read(ctx) == pytest.approx(30.0)


@pytest.mark.parametrize("reader", [cell_list_spec_share_pct, lum_relax_share_pct, on_demand_reduction_ms_per_scan])
def test_reader_that_finds_nothing_leaves_the_metric_out(reader):
    """A program without the timer (the parent of the change that added
    it, or a cell whose path never runs it) reads None."""
    assert reader.read(_ctx({"matching_time": 2.0})) is None
    assert reader.read({"records": [], "cfg": {}, "traffic": {}}) is None
