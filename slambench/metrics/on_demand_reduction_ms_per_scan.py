"""``ops.reduction`` via ``Scan.reduced_local``: the program's own
``on_demand_reduction_time`` (the reference's named phase, recorded
where the reduction is computed; it ends in a host array, so synced),
in ms a scan.  ``reduction_ms_per_scan`` times the same call from the
benchmark's side."""

REDUCTION = "on_demand_reduction_time"


def read(ctx):
    recs = ctx["records"]
    n = sum(r["n_scans"] for r in recs)
    t = sum(r["timers"].get(REDUCTION, 0.0) for r in recs)
    return 1e3 * t / n if n and t > 0 else None
