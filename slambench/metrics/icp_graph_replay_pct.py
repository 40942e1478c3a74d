"""The ICP loop (``models.icp.icp_pair``, the brute engine): the share of
its iterations that ran as a replay of a captured CUDA graph, from the
program's counters ``icp_graph_replays`` and ``brute_icp_iterations``
over the window's jobs.  None where no brute iteration ran, or where the
program keeps no such counters."""


def read(ctx):
    recs = ctx["records"]
    its = sum(r["counters"].get("brute_icp_iterations", 0.0) for r in recs)
    reps = sum(r["counters"].get("icp_graph_replays", 0.0) for r in recs)
    return 100.0 * reps / its if its > 0 else None
