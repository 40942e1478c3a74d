#!/usr/bin/env python3
"""Feature-based registration of both packages on the CPU, on chip_smoke's
phase 40 pair: the reference numbers behind that phase's pose gates.

    python scripts/reference_fbr_city.py [--port]

Two pairs (:func:`pairs`): city scans 0 and 1 of ``synth_city(13,
1_000_000)`` (raw, local frames, 16.7 m apart along the street), and
scan 0 against a copy of itself turned 0.15 rad about the up axis and
moved (50, 0, 30) cm, with 1.5 cm of fresh noise.  Each goes through
``register_fbr`` with 3600 x 1000 equirectangular panoramas (the
reference's fbr size), ORB (2000 features) and then SIFT (2000), in the
JAX package (OpenCV's detectors and matcher) and with ``--port`` also in
the port (device cpu; about a minute for SIFT).  Prints, a package, a
pair and a detector, the matches, the inliers, and the relative pose's
translation (cm) and rotation (deg) errors against the truth
(:func:`pose_errors`).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

WIDTH, HEIGHT = 3600, 1000
N_FEATURES = 2000


def pose_errors(T, T0, T1):
    """(translation cm, rotation deg) of T against the truth inv(T0)·T1
    (``register_fbr``'s model ≈ T·data with scan 0 the model)."""
    ref = np.linalg.inv(np.asarray(T0)) @ np.asarray(T1)
    dt = float(np.linalg.norm(np.asarray(T)[:3, 3] - ref[:3, 3]))
    c = (np.trace(np.asarray(T)[:3, :3].T @ ref[:3, :3]) - 1) / 2
    return dt, float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


TURN = (np.array([50.0, 0.0, 30.0]), np.array([0.0, 0.15, 0.0]))  # cm, rad


def pairs(locals_, true_mats):
    """{name: (model local, data local, T0, T1)}: city scans 0 and 1, and
    scan 0 against itself turned by TURN (data = inv(T)·scan 0 + noise,
    so model ≈ T·data with T0 = I, T1 = T)."""
    from tpu3dtk_torch.core import math3d

    T = np.asarray(math3d.euler_to_matrix4(TURN[0], TURN[1], xp=np))
    rng = np.random.default_rng(41)
    turned = np.asarray(math3d.transform3(np.linalg.inv(T), locals_[0].astype(np.float64)))
    turned = (turned + rng.normal(0, 1.5, turned.shape)).astype(np.float32)
    return {"scans 0-1": (locals_[0], locals_[1], true_mats[0], true_mats[1]),
            "scan 0 turned": (locals_[0], turned, np.eye(4), T)}


def main() -> int:
    from tpu3dtk_torch import synth

    locals_, true_mats, _odo = synth.synth_city(n_scans=13, n_pts=1_000_000, seed=23)
    todo = pairs(locals_[:2], true_mats[:2])
    del locals_
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpu3dtk.models import fbr as jfbr
    from tpu3dtk.ops.panorama import PanoramaParams

    for name, (m, d, T0, T1) in todo.items():
        for det in ("orb", "sift"):
            t0 = time.perf_counter()
            r = jfbr.register_fbr(m, d, jfbr.FbrParams(
                panorama=PanoramaParams(width=WIDTH, height=HEIGHT), detector=det,
                n_features=N_FEATURES))
            dt, dr = pose_errors(r["T"], T0, T1)
            print(f"JAX package, {name}, {det}: {r['n_matches']} matches, {r['n_inliers']} "
                  f"inliers, {time.perf_counter() - t0:.2f} s; error {dt:.4f} cm, {dr:.4f} deg",
                  flush=True)
    if "--port" in sys.argv:
        import torch

        from tpu3dtk_torch.models import fbr as tfbr
        from tpu3dtk_torch.ops.panorama import PanoramaParams as TPano

        torch.set_num_threads(min(8, os.cpu_count() or 1))
        for name, (m, d, T0, T1) in todo.items():
            for det in ("orb", "sift"):
                t0 = time.perf_counter()
                r = tfbr.register_fbr(m, d, tfbr.FbrParams(
                    panorama=TPano(width=WIDTH, height=HEIGHT), detector=det,
                    n_features=N_FEATURES), device="cpu")
                dt, dr = pose_errors(r["T"], T0, T1)
                print(f"port, {name}, {det}: {r['n_features']} features, {r['n_matches']} "
                      f"matches, {r['n_inliers']} inliers, {time.perf_counter() - t0:.2f} s; "
                      f"error {dt:.4f} cm, {dr:.4f} deg", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
