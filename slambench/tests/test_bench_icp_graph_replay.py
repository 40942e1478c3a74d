"""The reader of the ICP loop's graph-replay counters on hand-made job
records: the share of the brute engine's iterations that were CUDA graph
replays; a reader that finds no brute iteration leaves its metric out."""

from __future__ import annotations

import pytest

from slambench.metrics import icp_graph_replay_pct


def _ctx(*counters):
    return {"records": [{"counters": dict(c)} for c in counters], "cfg": {}, "traffic": {}}


def test_icp_graph_replay_pct_reads_the_program_counters():
    """The share of the brute ICP iterations that were graph replays, over
    the window's jobs."""
    both = _ctx({"brute_icp_iterations": 1000.0, "icp_graph_replays": 990.0},
                {"brute_icp_iterations": 3000.0, "icp_graph_replays": 3000.0, "chained_icp_loop_trips": 7.0})
    assert icp_graph_replay_pct.read(both) == pytest.approx(99.75)
    assert icp_graph_replay_pct.read(_ctx({"brute_icp_iterations": 40.0})) == 0.0


@pytest.mark.parametrize("counters", [[{"chained_icp_loop_trips": 204.0}, {}], []], ids=["chained_only", "no_records"])
def test_icp_graph_replay_pct_finds_nothing(counters):
    """None where no brute iteration ran: the chained engine alone, or a
    program without the counters (the parent of the change that added them)."""
    assert icp_graph_replay_pct.read(_ctx(*counters)) is None
