"""``torchveloslam`` — online SLAM with moving-object detection, the port
of ``tpuveloslam`` (the reference's src/veloslam/veloslam.cc flags: the
tracking mode, sliding-window matching; writes .frames like slam6D).

    python -m tpu3dtk_torch.cli.veloslam -f velodyne -r 10 -T 2 --window 3 DIR

Scans are processed as they are read (the online loop), reduced and
matched on the first CUDA card unless ``--device`` names another device
(``--device cpu``).  One line a scan: moving points, clusters, tracks and
dynamic tracks.  The spans ``read_scan_time`` and ``fh_merge_time`` and
the counter ``veloslam_icp_iterations`` (``utils.metrics.metrics``) time
the reads and the host union-find and count the window-ICP iterations.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="torchveloslam",
        description="online SLAM + moving-object tracking (3DTK veloslam)",
    )
    p.add_argument("dir")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=-1)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument("-d", "--dist", type=float, default=25.0)
    p.add_argument("-i", "--iter", type=int, default=50)
    p.add_argument(
        "-T", "--tracking", type=int, default=2, choices=(0, 1, 2),
        help="0 off, 1 classify, 2 classify-by-tracking (ref --tracking)",
    )
    p.add_argument("--window", type=int, default=3, help="sliding match window size")
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
    from ..models.veloslam import VeloParams, VeloSlam
    from ..utils.metrics import SCAN_LOAD, metrics

    device = torch.device(args.device) if args.device else default_device()
    pf = PointFilter(range_max=args.max_range if args.max_range > 0 else None)
    vs = VeloSlam(
        VeloParams(
            tracking=args.tracking,
            sliding_window=args.window,
            max_dist_match2=args.dist**2,
            max_iterations=args.iter,
        ),
        device=device,
    )
    scans = []
    raws = iter(read_scan_dir(
        args.dir, format=args.format, start=args.start, end=args.end, point_filter=pf,
    ))
    # streaming: scans are processed as they arrive (the online loop)
    while True:
        with metrics.time(SCAN_LOAD):
            raw = next(raws, None)
        if raw is None:
            break
        s = Scan.from_raw(raw, device=device)
        s.set_reduction(args.reduce, args.octree if args.reduce > 0 else 0)
        info = vs.process_scan(s)
        scans.append(s)
        if not args.quiet:
            print(
                f"scan {info['identifier']}: moving {info['n_moving']}/"
                f"{info['n_points']} clusters {info['n_clusters']} "
                f"tracks {info.get('n_tracks', 0)} "
                f"dynamic {info.get('n_dynamic', 0)}"
            )
    if not scans:
        print(f"no scans found in {args.dir}", file=sys.stderr)
        return 1
    out_dir = args.frames_out or args.dir
    for s in scans:
        mats = np.stack([f[0] for f in s.frames])
        types = [f[1] for f in s.frames]
        frames_io.write_frames(frames_io.frames_path(out_dir, s.identifier), mats, types)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
