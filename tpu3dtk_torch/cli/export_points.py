"""``torchexport`` — export registered point clouds, the port of
``tpuexport`` (the reference ``exportPoints`` tool,
src/slam6d/exportPoints.cc).

    python -m tpu3dtk_torch.cli.export_points -f uos -r 20 -O 1 -o points.pts DIR

applies each scan's final .frames pose (or its .pose with
``--use-pose``) and writes the points in the global frame: one file, or
one file a scan with ``--per-scan``.  With ``-r`` the scans are reduced
through the port's ``Scan`` on the first CUDA card unless ``--device``
names another device (``--device cpu``).  The spans ``read_scan_time``,
``on_demand_reduction_time`` and ``export_write_time``
(``utils.metrics.metrics``) time reading, reduction and the text write.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

EXPORT_WRITE = "export_write_time"  # metrics timer: the text write


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="torchexport")
    p.add_argument("dir")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=-1)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("--per-scan", action="store_true", help="one output file per scan")
    p.add_argument("--use-pose", action="store_true", help="use .pose instead of .frames")
    p.add_argument("-o", "--out", default="points.pts")
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
    from ..io.writer import write_pose, write_uos
    from ..utils.metrics import SCAN_LOAD, metrics

    device = torch.device(args.device) if args.device else default_device()
    pf = PointFilter(range_max=args.max_range if args.max_range > 0 else None)
    scans = iter(read_scan_dir(
        args.dir, format=args.format, start=args.start, end=args.end, point_filter=pf
    ))
    chunks = []
    while True:
        with metrics.time(SCAN_LOAD):
            raw = next(scans, None)
        if raw is None:
            break
        s = Scan.from_raw(raw, device=device)
        if not args.use_pose:
            fp = frames_io.frames_path(args.dir, raw.identifier)
            if os.path.exists(fp):
                s.set_pose(frames_io.final_pose(fp), frames_io.AlgoType.INVALID, record=False)
        if args.reduce > 0:
            s.set_reduction(args.reduce, args.octree)
            pts = s.reduced_global()  # Scan.reduced_local times the reduction
        else:
            pts = s.points_global()
        if args.per_scan:
            base = os.path.splitext(args.out)[0]
            with metrics.time(EXPORT_WRITE):
                write_uos(f"{base}{raw.identifier}.3d", np.asarray(pts))
                # the points are global already: an identity pose, as tpuexport writes
                write_pose(f"{base}{raw.identifier}.pose", np.zeros(3), np.zeros(3))
        else:
            chunks.append(np.asarray(pts))
        print(f"scan{raw.identifier}: {len(pts)} points")
    if chunks:
        with metrics.time(EXPORT_WRITE):
            write_uos(args.out, np.concatenate(chunks, axis=0))
        print(f"wrote {sum(map(len, chunks))} points -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
