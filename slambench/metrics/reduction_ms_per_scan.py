"""``ops.reduction`` via ``Scan.reduced_local``: the benchmark's span
around each scan's reduction (it returns host numpy, so it ends synced),
in ms a scan."""

def read(ctx):
    recs = ctx["records"]
    n = sum(r["n_scans"] for r in recs)
    return 1e3 * sum(r["reduce_s"] for r in recs) / n if n else None
