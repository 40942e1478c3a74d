#!/usr/bin/env python3
"""The JAX package's sequential ICP on the first scans of the h468 ring,
once per minimizer, on the CPU: the reference figures for the port's ICP
algorithm matrix (chip_smoke.py phase 17 runs the port's side on the
card and gates -a 4 and --normalShoot on these figures).

    JAX_PLATFORMS=cpu python scripts/reference_minimizers_h468.py [--port] [-i ITERS] [N_SCANS] [MINIMIZER ...]

Scans: ``tpu3dtk_torch.synth.synth_ring(468, 16384, seed=11)`` (equal to
``scripts/make_golden.py::synth_ring``), the first N_SCANS (default 5),
reduced by the JAX package at -r 10 -O 1 and matched with phase 4's
flags (-d 50 -i 50 --epsICP 1e-6; ``-i ITERS`` caps the iterations
instead of 50); napx, ``plane`` (quat with
point-to-plane pairing, --plane) and ``normalShoot`` (quat with normal
shooting, --normalShoot) estimate the normals first.  ``--port`` runs
the port's ``SequenceRegistration`` on the CPU instead, on the same
reduced points and normals.
Prints, per minimizer, the median consecutive relative-pose translation
error against ground truth (cm), the ICP iterations and the seconds,
beside odometry's median.  Each scan takes minutes per minimizer here
(14.4k x 14.4k brute NN per iteration on the CPU).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu3dtk.core.scan import TPUScan  # noqa: E402
from tpu3dtk.models.icp import IcpParams  # noqa: E402
from tpu3dtk.models.sequence import SequenceRegistration  # noqa: E402
from tpu3dtk_torch import synth  # noqa: E402

ALL = ("quat", "svd", "ortho", "dual", "helix", "apx", "lumeuler", "lumquat", "quatscale", "napx",
       "plane", "normalShoot")
PAIRINGS = {"plane": "closest_plane", "normalShoot": "along_normal"}


def median_rel_err(mats, ref):
    out = []
    for k in range(1, len(mats)):
        a = np.linalg.inv(mats[k - 1]) @ mats[k]
        b = np.linalg.inv(ref[k - 1]) @ ref[k]
        out.append(np.linalg.norm(a[:3, 3] - b[:3, 3]))
    return float(np.median(out))


def run_jax(base, kw):
    scans = []
    for s0 in base:
        s = TPUScan.from_points(s0.xyz, s0.identifier, pose=s0.transMatOrg)
        s._reduced_local = s0.reduced_local()
        if "normal reduced" in s0.channels:
            s.channels["normal reduced"] = s0.channels["normal reduced"]
        scans.append(s)
    res = SequenceRegistration(params=IcpParams(**kw)).run(scans)
    return np.stack([s.transMat for s in scans]), res


def run_port(base, kw):
    from tpu3dtk_torch import interop
    from tpu3dtk_torch.models.sequence import SequenceRegistration as TorchSequence

    scans, params = interop.scans_from_numpy([
        {"identifier": s.identifier, "xyz": s.xyz, "transMatOrg": s.transMatOrg,
         "reduced_local": s.reduced_local(), "normal reduced": s.channels.get("normal reduced")}
        for s in base
    ], icp_params=kw)
    for s in scans:
        s.device = "cpu"
    res = TorchSequence(params=params, device="cpu").run(scans)
    return np.stack([s.transMat for s in scans]), res


def main(argv):
    port = "--port" in argv
    argv = [a for a in argv if a != "--port"]
    iters = 50
    if "-i" in argv:
        k = argv.index("-i")
        iters = int(argv[k + 1])
        argv = argv[:k] + argv[k + 2:]
    n = int(argv[0]) if argv else 5
    names = argv[1:] or ALL
    locs, true, odo = synth.synth_ring(n_scans=468, n_pts=16384, seed=11, n_render=n)
    base = []
    for k in range(n):
        s = TPUScan.from_points(locs[k], f"{k:03d}", pose=odo[k])
        s.set_reduction(10.0, 1)
        s.reduced_local()
        base.append(s)
    print(f"{'port' if port else 'JAX package'}, {n} scans, -i {iters}; odometry: median "
          f"{median_rel_err(np.stack(odo[:n]), true[:n]):.4f} cm", flush=True)
    for name in names:
        if name in PAIRINGS:
            kw = dict(minimizer="quat", pairing=PAIRINGS[name])
        else:
            kw = dict(minimizer=name)
        if name in PAIRINGS or name == "napx":
            for s in base:
                s.reduced_normals_local()
        t0 = time.perf_counter()
        mats, res = (run_port if port else run_jax)(
            base, dict(max_dist_match2=2500.0, max_iterations=iters, epsilon=1e-6, **kw))
        err = median_rel_err(mats, true[:n])
        print(f"{name}: median {err:.4f} cm, {sum(r['iterations'] for r in res)} ICP iterations, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
