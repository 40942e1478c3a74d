"""The ICP loop's chained engine (``models.icp.icp_pair_chained``): the
share of its loop trips that ran as a replay of a captured CUDA graph,
from the program's counters ``chained_graph_replays`` and
``chained_icp_loop_trips`` over the window's jobs.  A job's record holds
only the counters that moved, so whether the program keeps the replay
counter at all is read from its metrics module.  None where no chained
trip ran, or where the program keeps no such counter."""


def read(ctx):
    from tpu3dtk_torch.utils import metrics

    if not hasattr(metrics, "CHAINED_GRAPH_REPLAYS"):
        return None
    recs = ctx["records"]
    trips = sum(r["counters"].get("chained_icp_loop_trips", 0.0) for r in recs)
    reps = sum(r["counters"].get("chained_graph_replays", 0.0) for r in recs)
    return 100.0 * reps / trips if trips > 0 else None
