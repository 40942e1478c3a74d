"""The entry points a job drives, one module each, found by the name a
traffic file gives under ``entry``.  Each module has ``run(scans, cfg,
device, trace) -> dict``: the entry's per-match ``infos`` and whatever
the comparison needs to replay the job (``closures``, ``links``); with
``trace`` it may also return ``k2_calls``, the (queries, model points,
calls) of its K2 calls."""
