"""The readings the limits of ``correct`` are set from, on the card.

    python3 -m slambench.calibrate --workload <cell> --seeds 11,12,... [--control 3] [--jobs 1]

For each seed: the cell's scans, ``--jobs`` registration jobs of the
program, and the comparison's numbers; for the first ``--control``
seeds also the numbers of the control (the reference in lower precision
put in the program's place, ``reference.plain.CONTROL``) on the same
sampled steps.  One JSON line per seed.  The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=0, help="seeds (the first ones) to read the control on")
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)
    root = Path.cwd()
    from .run import CACHES

    for k, v in CACHES.items():
        os.environ[k] = str(root / v)
    import torch

    from . import harness
    from .reference import check

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, root)
    cfg, traffic = cell.cfg, cell.traffic
    gen = importlib.import_module(f"slambench.gen.{cfg['generator']}")
    entry = importlib.import_module(f"slambench.entries.{traffic['entry']}")
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        sets = gen.generate(cfg["scene"], int(traffic["sets"]), seed, "cuda")
        plan = harness.job_plan(traffic, int(cfg["scene"]["n_scans"]))
        records = []
        for j in range(args.jobs):
            si, idx = plan[j % len(plan)]
            rec = harness.run_job(entry, sets[si], idx, cfg, "cuda", False)
            rec["set"] = si
            records.append(rec)
        raw = [s["locals"] for s in sets]
        line = {"seed": seed, "program": check.compare(records, raw, cfg, traffic["sample"], seed, "cuda",
                                                       log=lambda m: print(m, file=sys.stderr))}
        if n < args.control:
            line["control"] = check.compare(records, raw, cfg, traffic["sample"], seed, "cuda", control=True,
                                            log=lambda m: print("control" + m, file=sys.stderr))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del sets, records
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
