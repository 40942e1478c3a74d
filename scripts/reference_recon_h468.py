#!/usr/bin/env python3
"""``tpurecon`` and ``torchrecon --device cpu`` on the first scans of the
h468 ring (``synth_ring(468, 16384, seed 11)``, chip_smoke's phase 4
data) with the truth as .frames: each mesh's vertices against the
corridor's analytic surface, as chip_smoke's phase 33 measures them.

    python scripts/reference_recon_h468.py [N_SCANS] [REDUCE]

Defaults: 6 scans at -r 20 -m 1200; ``--method poisson`` and ``--method
imls --voxel 20 -K 12`` (chip_smoke runs them on 24 scans on the card).
Prints, a package and a method, the vertex and triangle counts, the
median distance and the share within one voxel of the method's grid
(pillars and the floor clutter excluded, as in chip_smoke), and the
wall time.  About half an hour on an 8-core CPU (the brute k-NN of the
IMLS grid in both packages).
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    reduce = sys.argv[2] if len(sys.argv) > 2 else "20"
    import chip_smoke
    from tpu3dtk.cli import recon as jcli
    from tpu3dtk_torch import synth
    from tpu3dtk_torch.cli import recon as tcli

    locals_, true_mats, odo_mats = synth.synth_ring(n_scans=468, n_pts=16384, seed=11, n_render=n)
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "scans")
        synth.write_scan_dir(d, locals_, odo_mats)
        chip_smoke._truth_frames(d, true_mats)
        for method, flags in (("poisson", []), ("imls", ["--voxel", "20", "-K", "12"])):
            for pkg, cli, extra in (("jax", jcli, []), ("port", tcli, ["--device", "cpu"])):
                out = os.path.join(tmp, f"{pkg}_{method}.ply")
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main([d, "--method", method, *flags, "-r", reduce, "-m", "1200",
                                   "-o", out, *extra])
                wall = time.perf_counter() - t0
                v, f = chip_smoke._read_ply_mesh(out)
                if method == "poisson":
                    pts = np.concatenate([
                        np.asarray(loc, np.float64)[np.linalg.norm(loc, axis=1) < 1200]
                        @ T[:3, :3].T + T[:3, 3] for loc, T in zip(locals_, true_mats)])
                    voxel = (float((pts.max(0) - pts.min(0)).max()) * 1.16) / 127
                    if pkg == "port":
                        voxel = float(re.search(r"voxel ([\d.]+) cm", buf.getvalue()).group(1))
                else:
                    voxel = 20.0
                dist, keep = chip_smoke.ring_surface_distance(v)
                print(f"{pkg} {method} ({n} scans, -r {reduce} -m 1200): rc {rc}, {len(v)} vertices, "
                      f"{len(f)} triangles, median distance {np.median(dist[keep]):.3f} cm, "
                      f"{(dist[keep] <= voxel).mean():.4f} within one voxel ({voxel:.3f} cm), "
                      f"{wall:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
