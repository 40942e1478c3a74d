"""The ICP loop (``models.sequence`` + ``models.icp``): iterations the
entry reports for its matches, over the program's ``matching_time``
timer (host clock; each match ends in a host read)."""

def read(ctx):
    recs = ctx["records"]
    its = sum(i["iterations"] for r in recs for i in r["infos"])
    t = sum(r["timers"].get("matching_time", 0.0) for r in recs)
    return its / t if its and t > 0 else None
