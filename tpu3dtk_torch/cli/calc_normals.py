"""``torchnormals`` — normal estimation, the port of ``tpunormals`` (the
reference's ``bin/calc_normals``, src/normals/calc_normals.cc): reads
scans, estimates normals with the selected method, writes
``scanNNN.3d`` files in uos_normal layout (x y z nx ny nz) plus the
passthrough ``.pose``.

    python -m tpu3dtk_torch.cli.calc_normals -r 10 -O 1 -g adaptive -o OUT DIR

Methods (ref src/slam6d/normals.cc:705 family):
  knn        exact k-NN PCA            (calculateNormalsKNN)
  adaptive   k-ladder adaptive PCA     (calculateNormalsAdaptiveKNN)
  apx        subset-approximate PCA    (calculateNormalsApxKNN)
  panorama   range-image neighborhood  (calculateNormalsPANORAMA)

Runs on the first CUDA card unless ``--device`` names another device
(``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="torchnormals",
        description="scan normal estimation (3DTK calc_normals)",
    )
    p.add_argument("dir")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=-1)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument(
        "-g", "--ntype", choices=("knn", "adaptive", "apx", "panorama"),
        default="knn",
    )
    p.add_argument("-K", "--knearest", type=int, default=20)
    p.add_argument("-o", "--out", default=None, help="output dir")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument(
        "--device", default=None,
        help="torch device: cuda[:N] or cpu (default: the first card)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .. import default_device
    from ..core.scan import Scan
    from ..io.scandir import PointFilter, read_scan_dir
    from ..ops import normals as nrm

    device = torch.device(args.device) if args.device else default_device()
    pf = PointFilter(range_max=args.max_range if args.max_range > 0 else None)
    out_dir = args.out or args.dir
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for raw in read_scan_dir(
        args.dir, format=args.format, start=args.start, end=args.end,
        point_filter=pf,
    ):
        s = Scan.from_raw(raw, device=str(device))
        s.set_reduction(args.reduce, args.octree if args.reduce > 0 else 0)
        pts = np.asarray(s.reduced_local())
        mask = np.ones(len(pts), bool)
        vp = np.zeros(3, np.float32)  # scanner at the local origin
        if args.ntype == "knn":
            n = nrm.estimate_normals_knn(pts, mask, vp, k=args.knearest, device=device)
        elif args.ntype == "adaptive":
            n = nrm.estimate_normals_adaptive_knn(pts, mask, vp, device=device)
        elif args.ntype == "apx":
            n = nrm.estimate_normals_apx_knn(pts, mask, vp, k=args.knearest, device=device)
        else:
            n = nrm.estimate_normals_panorama(pts, device=device)
        if isinstance(n, torch.Tensor):
            n = n.cpu().numpy()
        with open(os.path.join(out_dir, f"scan{s.identifier}.3d"), "w") as f:
            for p, v in zip(pts, n):
                f.write(f"{p[0]} {p[1]} {p[2]} {v[0]} {v[1]} {v[2]}\n")
        pose_src = os.path.join(args.dir, f"scan{s.identifier}.pose")
        pose_dst = os.path.join(out_dir, f"scan{s.identifier}.pose")
        if os.path.exists(pose_src) and pose_src != pose_dst:
            with open(pose_src) as a, open(pose_dst, "w") as b:
                b.write(a.read())
        count += 1
        if not args.quiet:
            print(f"scan {s.identifier}: {len(pts)} normals ({args.ntype})")
    if count == 0:
        print(f"no scans found in {args.dir}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
