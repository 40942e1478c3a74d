"""The reader of the chained ICP engine's graph-replay counters on
hand-made job records: the share of the chained loop trips that were
CUDA graph replays; a reader that finds no chained trip, or a program
without the replay counter, leaves its metric out."""

from __future__ import annotations

import pytest

from slambench.metrics import chained_graph_replay_pct


def _ctx(*counters):
    return {"records": [{"counters": dict(c)} for c in counters], "cfg": {}, "traffic": {}}


def test_chained_graph_replay_pct_reads_the_program_counters():
    """The share of the chained loop trips that were graph replays, over
    the window's jobs: a job that captured (one trip eager) and one that
    replayed every trip; a job record holds only the counters that moved,
    so a window with no replay reads 0."""
    both = _ctx({"chained_icp_loop_trips": 204.0, "chained_graph_replays": 187.0,
                 "chained_lum_link_calls": 13.0},
                {"chained_icp_loop_trips": 196.0, "chained_graph_replays": 196.0,
                 "brute_icp_iterations": 5.0})
    assert chained_graph_replay_pct.read(both) == pytest.approx(95.75)
    assert chained_graph_replay_pct.read(_ctx({"chained_icp_loop_trips": 40.0})) == 0.0


@pytest.mark.parametrize("counters", [
    [{"brute_icp_iterations": 900.0, "icp_graph_replays": 900.0}, {}],
    [],
], ids=["brute_only", "no_records"])
def test_chained_graph_replay_pct_finds_nothing(counters):
    """None where no chained trip ran: the brute engine alone, or no
    records."""
    assert chained_graph_replay_pct.read(_ctx(*counters)) is None


def test_chained_graph_replay_pct_on_a_program_without_the_counter(monkeypatch):
    """None on a program that keeps no replay counter (the parent of the
    change that added it), though its chained trips ran."""
    from tpu3dtk_torch.utils import metrics

    monkeypatch.delattr(metrics, "CHAINED_GRAPH_REPLAYS")
    ctx = _ctx({"chained_icp_loop_trips": 204.0, "chained_lum_link_calls": 13.0})
    assert chained_graph_replay_pct.read(ctx) is None
