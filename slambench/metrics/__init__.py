"""Per-layer metric readers, one module per metric named as in
BENCHMARK.json.  Each has ``read(ctx) -> float | None``; ``ctx`` holds
the window's job ``records``, the ``profile`` summary of the traced job
run before the window (its record, device time by kernel name,
launches, busy and window seconds), the configuration ``cfg`` and the
``traffic``.  A reader that finds nothing to read returns None and the
metric is left out."""


def share_pct(ctx, timers) -> float | None:
    recs = ctx["records"]
    num = sum(r["timers"].get(t, 0.0) for r in recs for t in timers)
    wall = sum(r["wall_s"] for r in recs)
    return 100.0 * num / wall if num > 0 and wall > 0 else None
