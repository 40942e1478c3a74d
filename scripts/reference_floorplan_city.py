#!/usr/bin/env python3
"""The floor plan of both packages on the CPU, on chip_smoke's phase 39
synth at a twentieth of its density: the reference number behind that
phase's facade-coverage gate.

    python scripts/reference_floorplan_city.py [--port-only]

The 13 raw 1M-point scans of ``synth_city(13, 1_000_000)`` in the world
frame, every STRIDE-th point, go through ``extract_floorplan`` (10 cm
cells, the 50-200 cm band) in the JAX package (``cv2.HoughLinesP``) and
in the port (``ops.lines.hough_lines_p``, device cpu).  Prints, a
package, the segments, those of at least 2 m, how many of those lie
within 15 cm of a facade line of ``synth.city_planes()``, and the share
of the facade length in view that they cover (:func:`facade_coverage`).
A few minutes on one CPU.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

STRIDE = 20
RES = 10.0
BAND = (50.0, 200.0)
MIN_SEG = 200.0  # cm: the segments the gates look at
NEAR = 15.0  # cm from a facade line
SAMPLE = 5.0  # cm between facade samples


def facade_lines():
    """synth_city's facade segments in (x, z): ((x0, z0), (x1, z1)) for the
    four sides of each block."""
    from tpu3dtk_torch import synth

    out = []
    for bx in range(4):
        for bz in range(4):
            x0 = synth.CITY_ORIGIN + bx * synth.CITY_PITCH
            z0 = synth.CITY_ORIGIN + bz * synth.CITY_PITCH
            x1, z1 = x0 + synth.CITY_BLOCK, z0 + synth.CITY_BLOCK
            out += [((x0, z0), (x0, z1)), ((x1, z0), (x1, z1)),
                    ((x0, z0), (x1, z0)), ((x0, z1), (x1, z1))]
    return out


def _seg_dist(p, a, b):
    """Distance of points p [N,2] to the segment a-b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = b - a
    t = np.clip(((p - a) @ d) / max(d @ d, 1e-12), 0.0, 1.0)
    return np.linalg.norm(p - (a + t[:, None] * d), axis=1)


def segments_near_facades(segs, near=NEAR, min_len=MIN_SEG):
    """(segments of at least ``min_len``, how many of them have both ends
    within ``near`` of one facade's line)."""
    from tpu3dtk_torch import synth

    planes = [(n, d) for n, d in synth.city_planes()[1:]]
    long_ = [s for s in segs if s.length >= min_len]
    ok = 0
    for s in long_:
        for n, d in planes:
            ax = 0 if n[0] else 2
            k = 0 if ax == 0 else 1
            if abs(s.p0[k] - d) <= near and abs(s.p1[k] - d) <= near:
                ok += 1
                break
    return long_, ok


def facade_coverage(segs, hits, origin, res=RES, near=NEAR, min_len=MIN_SEG):
    """Share of the facade length in view covered by segments of at least
    ``min_len``: facades sampled every SAMPLE cm; a sample is in view when
    its grid cell holds a hit, covered when a long segment passes within
    ``near``.  ``hits`` [W, H] and ``origin`` [2] of the floor plan's
    grid (x, z)."""
    W, H = hits.shape
    seen = cov = 0
    long_ = [s for s in segs if s.length >= min_len]
    for a, b in facade_lines():
        n = int(np.hypot(b[0] - a[0], b[1] - a[1]) / SAMPLE) + 1
        t = np.linspace(0.0, 1.0, n)
        p = np.asarray(a) + t[:, None] * (np.asarray(b) - np.asarray(a))
        ij = np.floor((p - origin) / res).astype(int)
        inside = (ij[:, 0] >= 0) & (ij[:, 0] < W) & (ij[:, 1] >= 0) & (ij[:, 1] < H)
        view = np.zeros(n, bool)
        for di in (-1, 0):
            for dj in (-1, 0):
                ii = np.clip(ij[:, 0] + di, 0, W - 1)
                jj = np.clip(ij[:, 1] + dj, 0, H - 1)
                view |= inside & (hits[ii, jj] > 0)
        c = np.zeros(n, bool)
        for s in long_:
            c |= _seg_dist(p, s.p0, s.p1) <= near
        seen += int(view.sum())
        cov += int((view & c).sum())
    return cov / max(seen, 1), seen


def scene(locals_, true_mats, stride=STRIDE):
    """World-frame points (every ``stride``-th) and scanner origins."""
    from tpu3dtk_torch.core import math3d

    pts = [np.asarray(math3d.transform3(np.asarray(T), loc.astype(np.float64)))[::stride]
           for loc, T in zip(locals_, true_mats)]
    return pts, [np.asarray(T)[:3, 3] for T in true_mats]


def report(label, segs, pts, origins, grid_mod, wall):
    g = grid_mod.make_occupancy_grid(
        pts, origins, grid_mod.Grid2DParams(resolution=RES, y_min=BAND[0], y_max=BAND[1],
                                            count_free=False),
        **({"device": "cpu"} if "torch" in grid_mod.__name__ else {}))
    long_, ok = segments_near_facades(segs)
    share, seen = facade_coverage(segs, g.hits, g.origin)
    print(f"{label}: {len(segs)} segments in {wall:.2f} s, {len(long_)} of >= {MIN_SEG / 100:g} m, "
          f"{ok} of them within {NEAR:g} cm of a facade line; facade coverage {share:.4f} of "
          f"{seen} samples in view", flush=True)
    return share


def main() -> int:
    port_only = "--port-only" in sys.argv
    from tpu3dtk_torch import synth

    locals_, true_mats, _odo = synth.synth_city(n_scans=13, n_pts=1_000_000, seed=23)
    pts, origins = scene(locals_, true_mats)
    del locals_
    print(f"13 scans, every {STRIDE}th point: {sum(map(len, pts))} points", flush=True)
    if not port_only:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from tpu3dtk.models import floorplan as jfp
        from tpu3dtk.models import grid2d as jg

        t0 = time.perf_counter()
        segs = jfp.extract_floorplan(pts, origins, jfp.FloorplanParams(
            resolution=RES, y_min=BAND[0], y_max=BAND[1]))
        report("JAX package", segs, pts, origins, jg, time.perf_counter() - t0)
    import torch

    from tpu3dtk_torch.models import floorplan as tfp
    from tpu3dtk_torch.models import grid2d as tg

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    segs = tfp.extract_floorplan(pts, origins, tfp.FloorplanParams(
        resolution=RES, y_min=BAND[0], y_max=BAND[1]), device="cpu")
    report("port", segs, pts, origins, tg, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
