"""One run of one cell: set-up, the measured window of registration
jobs, the traced job, the comparison with the plain reference, and the
result line.

A job is one user's registration run: fresh ``Scan`` objects from host
arrays, as a file read leaves them; their reduction on the card (the
benchmark's ``reduce`` span around each ``reduced_local()``, which
returns host numpy and so ends synced); then the entry the traffic names,
until the map's final poses are on the host.  Each job builds new scans,
so no content-keyed cache of the program carries over.  The window is a
closed loop of jobs: a job starts when the last ended, the job in flight
when the time runs out is finished, and the window ends with it.

Everything a cell needs is found by name: its configuration and traffic
files, the generator the configuration names (``gen/<name>.py``), the
entry the traffic names (``entries/<name>.py``) and a reader for each
per-layer metric (``metrics/<name>.py``).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import time
from pathlib import Path

import numpy as np
import torch

PKG = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its configuration
    and traffic files and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((PKG / "workloads" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved else [])]
    return Cell(name, int(w["chips"]), cfg, traffic, e2e, per_layer)


def job_plan(traffic: dict, n_scans: int) -> list[tuple[int, list[int]]]:
    """(set, scan indices) of each job, in the order the window runs
    them: every set cut into runs of ``job_scans`` scans."""
    per = int(traffic["job_scans"])
    return [(si, list(range(a, a + per))) for si in range(int(traffic["sets"]))
            for a in range(0, n_scans - per + 1, per)]


def _snapshot():
    from tpu3dtk_torch.utils.metrics import metrics

    return ({k: m.total for k, m in metrics.timers.items()},
            {k: m.total for k, m in metrics.counters.items()})


def _delta(a, b):
    return {k: v - a.get(k, 0.0) for k, v in b.items() if v != a.get(k, 0.0)}


def run_job(entry, data: dict, scans_idx: list[int], cfg: dict, device: str, trace: bool) -> dict:
    """One registration job on scans ``scans_idx`` of the generated set
    ``data``; returns its record (the program's reduced points and
    frames, the entry's output, the job's wall time, spans, and the
    program's timers and counters over it)."""
    from tpu3dtk_torch.core.scan import Scan

    t_before, c_before = _snapshot()
    red = cfg["reduction"]
    t0 = time.perf_counter()
    with torch.profiler.record_function("job"):
        scans, reduce_s = [], 0.0
        for n, k in enumerate(scans_idx):
            s = Scan.from_points(data["locals"][k], f"{n:03d}", data["odo"][k])
            s.device = device
            s.set_reduction(red["voxel_cm"], red["nrpts"])
            tr = time.perf_counter()
            with torch.profiler.record_function("reduce"):
                s.reduced_local()
            reduce_s += time.perf_counter() - tr
            scans.append(s)
        te = time.perf_counter()
        with torch.profiler.record_function("entry"):
            out = entry.run(scans, cfg, device, trace)
    t1 = time.perf_counter()
    t_after, c_after = _snapshot()
    return {
        "scans": list(scans_idx),
        "n_scans": len(scans),
        "frames": [[(np.array(T, np.float64), int(tag)) for T, tag in s.frames] for s in scans],
        "origin": [s.transMatOrg.copy() for s in scans],
        "reduced": [s.reduced_local() for s in scans],
        "wall_s": t1 - t0,
        "entry_s": t1 - te,
        "reduce_s": reduce_s,
        "timers": _delta(t_before, t_after),
        "counters": _delta(c_before, c_after),
        **out,
    }


def _profile_summary(prof, rec) -> dict:
    from . import trace as tr

    evs = tr.events_of(prof)
    lo, hi = next((e.start, e.end) for e in evs if not e.device and e.name == "job")
    return {
        "busy_s": tr.busy_seconds(evs, lo, hi),
        "window_s": hi - lo,
        "device_s": tr.device_time_by_name(evs),
        "device_ops": tr.top_device_ops(evs),
        "idle_gaps": tr.idle_gaps(evs, lo, hi),
        "record": rec,
    }


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             log=print) -> dict:
    """Set up, measure, trace and check one run of ``cell``; returns the
    result object (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``)."""
    from .reference import check as ref_check

    cfg, traffic = cell.cfg, cell.traffic
    gen = importlib.import_module(f"slambench.gen.{cfg['generator']}")
    entry = importlib.import_module(f"slambench.entries.{traffic['entry']}")
    scene = cfg["scene"]
    t_gen = time.perf_counter()
    sets = gen.generate(scene, int(traffic["sets"]), seed, device)
    plan = job_plan(traffic, int(scene["n_scans"]))
    t_warm = time.perf_counter()

    warm = traffic["warm"]
    if "scene" in warm:
        wdata = gen.generate({**scene, **warm["scene"]}, 1, seed + 1, device)[0]
        run_job(entry, wdata, list(range(int(warm["scene"]["n_scans"]))), cfg, device, trace)
    else:
        run_job(entry, sets[0], plan[0][1][: int(warm["scans"])], cfg, device, trace)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: start to the scans {t_gen - t_start:.3f} s (imports, the card), "
        f"scans {t_warm - t_gen:.3f} s, warm job {t_start + setup_s - t_warm:.3f} s")

    prof_rec = None
    if trace:
        # the traced job runs before the window: the profiler's own cost
        # (its teardown takes seconds on a job of 10^5 launches) stays out
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            prof_rec = run_job(entry, sets[plan[0][0]], plan[0][1], cfg, device, trace)
            if device != "cpu":
                torch.cuda.synchronize()
        prof_rec["set"] = plan[0][0]
        prof_summary = _profile_summary(prof, prof_rec)
        del prof

    records = []
    t0 = time.perf_counter()
    while True:
        si, idx = plan[len(records) % len(plan)]
        rec = run_job(entry, sets[si], idx, cfg, device, trace)
        rec["set"] = si
        records.append(rec)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    log("jobs: " + ", ".join(f"{r['n_scans']} scans {r['wall_s']:.3f} s" for r in records))
    peak = int(torch.cuda.max_memory_allocated()) if device != "cpu" else 0
    if device != "cpu":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checked = records if prof_rec is None else [prof_rec, *records]
    numbers = ref_check.compare(checked, [s["locals"] for s in sets], cfg, traffic["sample"], seed, device,
                                log=log)
    limits = traffic["limits"]
    checks = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    correct = all(v["value"] is not None and v["value"] <= v["limit"] for v in checks.values())
    log(f"reference check: {time.perf_counter() - t_check:.1f} s over {len(checked)} jobs")

    result = {"correct": correct, "attempted": len(checked), "failed": 0}
    if trace:
        ctx = {"records": records, "profile": prof_summary, "cfg": cfg, "traffic": traffic}
        vals = {}
        for m in cell.per_layer:
            v = importlib.import_module(f"slambench.metrics.{m['name']}").read(ctx)
            if v is not None:
                vals[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = vals
    else:
        total = sum(r["n_scans"] for r in records)
        e2e = {"scans_per_s": total / window_s, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in e2e}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = prof_summary["busy_s"]
        dev["window_s"] = prof_summary["window_s"]
        result["breakdown"] = {"device_ops": prof_summary["device_ops"], "idle_gaps": prof_summary["idle_gaps"]}
    result["device"] = dev
    result["checks"] = checks
    return result
