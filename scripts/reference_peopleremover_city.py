#!/usr/bin/env python3
"""The people remover of both packages on the CPU, on chip_smoke's phase 34
synth at a twentieth of its density: the reference numbers behind that
phase's gates.

    python scripts/reference_peopleremover_city.py [--port-only]

The 13 raw 1M-point scans of ``synth_city(13, 1_000_000)`` with 10 person
columns of 1500 points each added (``synth.city_people``), in the world
frame, every STRIDE-th point kept (chip_smoke computes the same arrays);
then ``remove_dynamic_points`` at voxel 10 with ``maxrange_method`` "none"
on all 13 scans and "normals" on scans 0-2, in the JAX package and in the
port (device cpu).  Prints, a package and a method, the share of person
points and of static points removed, the wall time, and the keep masks'
differences between the packages.  About 15 minutes on one 8-core CPU.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

STRIDE = 20
VOXEL = 10.0


def scene(locals_, true_mats, people, stride=STRIDE):
    """(world points, scanner origins, person masks) a scan: the raw scans
    with their person columns, every ``stride``-th point."""
    from tpu3dtk_torch.core import math3d

    pts, origins, is_person = [], [], []
    for loc, T, (_boxes, person_pts) in zip(locals_, true_mats, people):
        static = np.asarray(math3d.transform3(np.asarray(T), loc.astype(np.float64)))
        world = np.concatenate([static, person_pts])
        person = np.zeros(len(world), bool)
        person[len(static):] = True
        pts.append(world[::stride])
        origins.append(np.asarray(T)[:3, 3])
        is_person.append(person[::stride])
    return pts, origins, is_person


def main() -> int:
    port_only = "--port-only" in sys.argv
    from tpu3dtk_torch import synth

    locals_, true_mats, _odo = synth.synth_city(n_scans=13, n_pts=1_000_000, seed=23)
    all_pts, all_origins, all_person = scene(locals_, true_mats, synth.city_people(true_mats))
    print(f"13 scans of {min(map(len, all_pts))}-{max(map(len, all_pts))} points, "
          f"{int(all_person[0].sum())} a scan on person columns; voxel {VOXEL}")
    results = {}
    for mode, n in (("none", 13), ("normals", 3)):
        pts, origins, is_person = all_pts[:n], all_origins[:n], all_person[:n]
        for pkg in (("port",) if port_only else ("jax", "port")):
            if pkg == "jax":
                from tpu3dtk.models.peopleremover import PeopleRemoverParams, remove_dynamic_points

                run = lambda: remove_dynamic_points(  # noqa: E731
                    pts, origins, PeopleRemoverParams(voxel_size=VOXEL, maxrange_method=mode))
            else:
                from tpu3dtk_torch.models import peopleremover as tpr

                run = lambda: tpr.remove_dynamic_points(  # noqa: E731
                    pts, origins, tpr.PeopleRemoverParams(voxel_size=VOXEL, maxrange_method=mode),
                    device="cpu")
            t0 = time.perf_counter()
            keep = run()
            wall = time.perf_counter() - t0
            removed_p = np.mean(np.concatenate([~k[m] for k, m in zip(keep, is_person)]))
            removed_s = np.mean(np.concatenate([~k[~m] for k, m in zip(keep, is_person)]))
            results[(pkg, mode)] = keep
            print(f"{pkg} {mode} ({n} scans): person points removed {removed_p:.4f}, static points removed "
                  f"{removed_s:.6f}, {wall:.1f} s", flush=True)
        if not port_only:
            diff = sum(int((a != b).sum()) for a, b in zip(results[("jax", mode)],
                                                          results[("port", mode)]))
            print(f"{mode}: keep masks differ in {diff} of {sum(map(len, pts))} points")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
