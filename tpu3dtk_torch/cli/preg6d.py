"""``torchplanereg`` — plane-based post-registration, the port of
``tpuplanereg`` (the reference's ``bin/preg6d`` program,
src/preg6d/planereg.cc: scan dir, eps gates, optimizer choice).

    python -m tpu3dtk_torch.cli.preg6d -r 10 --frames-out OUT DIR
    python -m tpu3dtk_torch.cli.preg6d --optimizer adadelta --iter 2000 DIR

Reads the scans of DIR (starting from their ``.frames`` poses where
present), detects planes in the condensed cloud (SHT), registers every
scan against them and writes ICP-tagged ``.frames`` to ``--frames-out``
(default DIR).  Runs on the first CUDA card unless ``--device`` names
another device (``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="torchplanereg",
        description="plane-based post-registration (3DTK preg6d)",
    )
    p.add_argument("dir", help="scan directory (registered; .frames read)")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=-1)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument(
        "--eps-hesse", type=float, default=25.0,
        help="max point-to-plane distance for association (cm)",
    )
    p.add_argument("--iter", type=int, default=50)
    p.add_argument(
        "--optimizer", choices=("gaussnewton", "adadelta"),
        default="gaussnewton",
    )
    p.add_argument(
        "--min-inliers", type=int, default=200,
        help="Hough plane extraction: min inliers per plane",
    )
    p.add_argument("--max-planes", type=int, default=12)
    p.add_argument("--frames-out", default=None)
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
    from ..io import frames as frames_io
    from ..io.scandir import PointFilter, read_scan_dir
    from ..models.preg6d import PregParams, preg6d
    from ..models.shapes import HoughParams

    device = torch.device(args.device) if args.device else default_device()
    pf = PointFilter(range_max=args.max_range if args.max_range > 0 else None)
    scans = []
    for raw in read_scan_dir(
        args.dir, format=args.format, start=args.start, end=args.end,
        point_filter=pf,
    ):
        s = Scan.from_raw(raw, device=str(device))
        s.set_reduction(args.reduce, args.octree if args.reduce > 0 else 0)
        fp = frames_io.frames_path(args.dir, s.identifier)
        if os.path.exists(fp):
            s.set_pose(np.asarray(frames_io.final_pose(fp)), 2, record=False)
        scans.append(s)
    if not scans:
        print(f"no scans found in {args.dir}", file=sys.stderr)
        return 1

    infos = preg6d(
        scans,
        params=PregParams(
            eps_hesse=args.eps_hesse,
            iterations=args.iter,
            optimizer=args.optimizer,
        ),
        hough=HoughParams(min_inliers=args.min_inliers, max_planes=args.max_planes),
        device=device,
    )
    if not args.quiet:
        for r in infos:
            print(
                f"scan {r['identifier']}: iter {r['iterations']} "
                f"E {r['energy']:.3f} assoc {r['associated']}"
            )
    out_dir = args.frames_out or args.dir
    for s in scans:
        mats = np.stack([f[0] for f in s.frames])
        types = [f[1] for f in s.frames]
        frames_io.write_frames(frames_io.frames_path(out_dir, s.identifier), mats, types)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
