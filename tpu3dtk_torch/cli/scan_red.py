"""``torchscan_red`` — point reduction and re-export, the port of
``tpuscan_red`` (the reference's ``scan_red``, src/slam6d/scan_red.cc):
OCTREE voxel reduction on the device (``ops.reduction.reduce_scan``) plus
the RANGE / INTERPOLATE panorama paths (projection → range-image
downscale → inverse projection, scan_red.cc:81,201-207), which are host
numpy in both packages (``ops.panorama``).

    python -m tpu3dtk_torch.cli.scan_red -s 0 -e 12 -r OCTREE -v 10 --octree 0 -f xyz DIR

writes reduced scans + poses to DIR/reduced/ in uos format.  Runs on the
first CUDA card unless ``--device`` names another device (``--device
cpu``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="torchscan_red")
    p.add_argument("dir")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=-1)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument(
        "-r", "--reduction", default="OCTREE",
        choices=["OCTREE", "RANGE", "INTERPOLATE"],
    )
    p.add_argument("-p", "--projection", default="equirectangular")
    p.add_argument("-W", "--width", type=int, default=3600)
    p.add_argument("-H", "--height", type=int, default=1000)
    p.add_argument("-y", "--scale", type=float, default=0.5)
    p.add_argument("-v", "--voxel", type=float, default=10.0)
    p.add_argument(
        "--octree", type=int, default=0,
        help="pts per voxel: 0=center, 1=one random, -1=mean, n=n random",
    )
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-o", "--out", default=None, help="output dir (default: dir/reduced)")
    p.add_argument(
        "--device", default=None,
        help="torch device: cuda[:N] or cpu (default: the first card)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .. import default_device
    from ..io.scandir import PointFilter, read_scan_dir
    from ..io.writer import write_pose, write_uos
    from ..ops.panorama import PanoramaParams, reduce_interpolate, reduce_range
    from ..ops.reduction import reduce_scan

    device = torch.device(args.device) if args.device else default_device()
    out_dir = args.out or os.path.join(args.dir, "reduced")
    os.makedirs(out_dir, exist_ok=True)
    pf = PointFilter(range_max=args.max_range if args.max_range > 0 else None)
    n = 0
    for raw in read_scan_dir(
        args.dir, format=args.format, start=args.start, end=args.end, point_filter=pf
    ):
        if args.reduction == "OCTREE":
            red = reduce_scan(raw.xyz.astype(np.float32), args.voxel, args.octree,
                              device=device)
        else:
            pp = PanoramaParams(
                width=args.width,
                height=args.height,
                method=args.projection.lower(),
                max_range=args.max_range if args.max_range > 0 else None,
            )
            fn = reduce_range if args.reduction == "RANGE" else reduce_interpolate
            red, _ = fn(raw.xyz, pp, scale=args.scale)
        write_uos(os.path.join(out_dir, f"scan{raw.identifier}.3d"), red)
        write_pose(
            os.path.join(out_dir, f"scan{raw.identifier}.pose"),
            raw.pose_pos,
            raw.pose_theta,
        )
        print(f"scan{raw.identifier}: {len(raw.xyz)} -> {len(red)} points")
        n += 1
    print(f"reduced {n} scans -> {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
