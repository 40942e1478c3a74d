"""``torchplanes`` — plane detection, the port of ``tpuplanes`` (the
reference's ``bin/planes``, src/shapes/planes.cc: Hough plane
extraction, writes ``planes/plane###.n`` normal files + ``planes.list``).

    python -m tpu3dtk_torch.cli.planes -f uos -r 20 -O 1 -C hough.cfg DIR

Reads scan ``-s`` of DIR, reduces it on the device, detects planes with
``-p rht`` (default) or ``-p sht``.  ``-C`` reads a ConfigFileHough file;
an explicit ``--min-inliers``, ``--max-planes`` or ``--dist-tol`` wins
over it, and ``-m`` wins over its ``MaxDist``.  Runs on the first CUDA
card unless ``--device`` names another device (``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="torchplanes", description="Hough plane detection (3DTK planes)"
    )
    p.add_argument("dir")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument(
        "-p", "--plane-algo", choices=("sht", "rht"), default="rht",
        help="standard or randomized Hough (ref -p)",
    )
    p.add_argument("--min-inliers", type=int, default=200)
    p.add_argument("--max-planes", type=int, default=20)
    p.add_argument("--dist-tol", type=float, default=10.0)
    p.add_argument(
        "-C", "--config", default=None,
        help="ConfigFileHough key-value file (ref bin/hough.cfg,"
        " src/shapes/ConfigFileHough.cc); explicit flags override it",
    )
    p.add_argument("-o", "--out", default="planes")
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
    from ..io.hough_config import hough_params_from_config, load_hough_config
    from ..io.scandir import PointFilter, read_scan_dir
    from ..models.shapes import HoughParams, detect_planes, detect_planes_rht

    device = torch.device(args.device) if args.device else default_device()
    cfg = load_hough_config(args.config) if args.config else None
    # -m wins; else the config's MaxDist (ConfigFileHough semantics)
    range_max = args.max_range if args.max_range > 0 else (
        cfg["MaxDist"] if cfg and cfg["MaxDist"] > 0 else None
    )
    scans = list(
        read_scan_dir(
            args.dir, format=args.format, start=args.start,
            end=args.start, point_filter=PointFilter(range_max=range_max),
        )
    )
    if not scans:
        print(f"no scan {args.start} in {args.dir}", file=sys.stderr)
        return 1
    s = Scan.from_raw(scans[0], device=str(device))
    s.set_reduction(args.reduce, args.octree if args.reduce > 0 else 0)
    pts = np.asarray(s.reduced_local())
    if cfg is not None:
        hp = hough_params_from_config(cfg)
        given = argv if argv is not None else sys.argv
        overrides = {
            name: getattr(args, name) for name in ("min_inliers", "max_planes", "dist_tol")
            if "--" + name.replace("_", "-") in given
        }
        if overrides:
            hp = dataclasses.replace(hp, **overrides)
    else:
        hp = HoughParams(
            min_inliers=args.min_inliers, max_planes=args.max_planes,
            dist_tol=args.dist_tol,
        )
    fn = detect_planes_rht if args.plane_algo == "rht" else detect_planes
    planes = fn(pts, hp, device=device)
    os.makedirs(args.out, exist_ok=True)
    listing = os.path.join(args.out, "planes.list")
    with open(listing, "w") as lst:
        for k, pl in enumerate(planes):
            path = os.path.join(args.out, f"plane{k:03d}.n")
            with open(path, "w") as f:
                f.write(f"{pl.normal[0]} {pl.normal[1]} {pl.normal[2]}\n")
                f.write(f"{pl.rho}\n")
                f.write(f"{pl.center[0]} {pl.center[1]} {pl.center[2]}\n")
                f.write(f"{pl.n_inliers}\n")
            lst.write(f"{path}\n")
            if not args.quiet:
                print(
                    f"plane {k}: n=({pl.normal[0]:.3f},{pl.normal[1]:.3f},"
                    f"{pl.normal[2]:.3f}) rho={pl.rho:.1f} "
                    f"inliers={pl.n_inliers}"
                )
    print(f"{len(planes)} planes -> {listing}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
