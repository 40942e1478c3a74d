"""The device: the share of the profiled job's wall time in which no
kernel, copy or set ran (1 - the union of their intervals)."""


def read(ctx):
    p = ctx["profile"]
    if p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
