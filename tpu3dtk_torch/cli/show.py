"""``torchshow`` — the port of ``tpushow`` (``tpu3dtk.cli.show``), the
offscreen counterpart of the reference ``show`` binary
(src/show/show_common.cc:678 display pipeline, src/show/program_options.cc
flag surface), on PyTorch and CUDA.

The reference opens a GL window; this renders PNGs with the same inputs
and semantics:

- loads scans + their ``.frames`` pose logs (registration replay),
- applies the selected frame (default: final pose, like show),
- renders orbit views or a ``.frames`` animation through the z-buffer
  splat (``ops.render``) on the card (``--device cpu`` for the CPU),
- ``--lod N`` renders each orbit view through the frustum-culled octree
  LOD cut of at most N points (``ops.octree``, ``render.lod_select``).

Examples:
    python -m tpu3dtk_torch.cli.show -m 2500 -r 10 -o views DIR
    python -m tpu3dtk_torch.cli.show --animate 24 -o anim DIR
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="torchshow",
        description="offscreen point-cloud viewer on PyTorch/CUDA (3DTK show counterpart)",
    )
    p.add_argument("dir", help="scan directory (with .frames if registered)")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=-1)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-M", "--min", type=float, default=-1, dest="min_range")
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument(
        "--loadOct", dest="load_oct", action="store_true",
        help="load scanNNN.oct octree caches (ref show --loadOct)",
    )
    p.add_argument(
        "--frameno", type=int, default=-1,
        help="frames index to apply (-1 = final pose, ref show default)",
    )
    p.add_argument(
        "--orbit", type=int, default=4,
        help="number of orbit views to render (0 disables)",
    )
    p.add_argument(
        "--animate", type=int, default=0,
        help="render N frames animating through the .frames history "
        "(ref show animation path)",
    )
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--pointsize", type=int, default=1)
    p.add_argument(
        "--color",
        choices=("height", "depth", "scan", "reflectance"),
        default="height",
        help="colormanager modes: height ramp, depth ramp, per-scan"
        " palette, reflectance ramp (reflectance needs -r disabled"
        " so the channel survives; falls back to height otherwise)",
    )
    p.add_argument(
        "--lod", type=int, default=0,
        help="per-frame point budget: render through the frustum-culled"
        " octree LOD cut instead of all points (ref show"
        " displayOctTreeCulledLOD, include/show/show_Boctree.h:504-561)",
    )
    p.add_argument("-o", "--out", default="torchshow_out", help="output dir")
    p.add_argument(
        "--device", default=None,
        help="torch device to render on: cuda[:N] or cpu (default: the first "
        "CUDA card; without a card the run stops with an error unless "
        "--device cpu is given)",
    )
    return p


def load_scene(args, device):
    """Scans + per-scan frames history -> (list of local clouds, list of
    [F,4,4] frame histories, list of reflectance channels or None)."""
    from ..core.scan import Scan
    from ..io import frames as frames_io
    from ..io.boctree import read_oct
    from ..io.scandir import PointFilter, read_scan_dir

    pf = PointFilter(
        range_max=args.max_range if args.max_range > 0 else None,
        range_min=args.min_range if args.min_range > 0 else None,
    )
    clouds, histories, reflects = [], [], []
    for raw in read_scan_dir(
        args.dir, format=args.format, start=args.start, end=args.end,
        point_filter=pf,
    ):
        s = Scan.from_raw(raw, device=str(device))
        s.set_reduction(args.reduce, args.octree if args.reduce > 0 else 0)
        if args.load_oct:
            op = os.path.join(args.dir, f"scan{s.identifier}.oct")
            if os.path.exists(op):
                s.load_reduced(read_oct(op))
        pts = s.reduced_local()
        fp = frames_io.frames_path(args.dir, s.identifier)
        if os.path.exists(fp):
            mats, _types = frames_io.read_frames(fp)
        else:
            mats = s.transMatOrg[None]
        clouds.append(np.asarray(pts))
        histories.append(np.asarray(mats))
        refl = raw.channels.get("reflectance")
        reflects.append(
            np.asarray(refl) if refl is not None and len(refl) == len(pts) else None
        )
    return clouds, histories, reflects


def world_points(clouds, histories, frameno: int):
    from ..core import math3d

    out = []
    for pts, mats in zip(clouds, histories):
        k = frameno if 0 <= frameno < len(mats) else len(mats) - 1
        out.append(np.asarray(math3d.transform3(mats[k], pts)))
    return np.concatenate(out, axis=0) if out else np.zeros((0, 3))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .. import default_device
    from ..io.png import write_png
    from ..ops import render

    device = torch.device(args.device) if args.device else default_device()
    clouds, histories, reflects = load_scene(args, device)
    if not clouds:
        print(f"no scans found in {args.dir}", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)

    colors = None
    if args.color == "scan":
        colors = render.color_by_scan([len(c) for c in clouds])
    elif args.color == "reflectance":
        if all(r is not None for r in reflects) and reflects:
            colors = render.color_by_value(np.concatenate(reflects))
        else:
            print("reflectance channel unavailable (reduced?); "
                  "falling back to height", file=sys.stderr)

    def render_to(path, pts, pose, pcolors=None):
        if args.color == "depth":
            _, depth = render.render_points(
                pts, pose, width=args.width, height=args.height,
                fov_deg=args.fov, point_size=args.pointsize, device=device,
            )
            lo = np.nanmin(depth) if np.isfinite(depth).any() else 0.0
            hi = np.nanmax(depth) if np.isfinite(depth).any() else 1.0
            img = render.color_by_depth(depth, lo, hi)
        else:
            img, _ = render.render_points(
                pts, pose, colors=pcolors, width=args.width,
                height=args.height, fov_deg=args.fov,
                point_size=args.pointsize, device=device,
            )
        write_png(path, img)
        return path

    written = []
    pts = world_points(clouds, histories, args.frameno)
    center = 0.5 * (pts.min(0) + pts.max(0))
    radius = float(np.linalg.norm(pts.max(0) - pts.min(0))) * 0.9 + 1.0
    tree = None
    if args.lod > 0:
        from ..ops.octree import build_octree

        # leaf edge ~ the scene size / 1024: deep enough that the LOD
        # cut, not the leaves, bounds per-frame work
        tree = build_octree(pts, max(radius / 1024.0, 1e-3))
    for k in range(args.orbit):
        pose = render.orbit_pose(center, radius, 360.0 * k / max(args.orbit, 1))
        view = pts
        vcolors = colors
        if tree is not None:
            view, _w = render.lod_select(
                tree, pose, fov_deg=args.fov, width=args.width,
                height=args.height, budget=args.lod,
            )
            vcolors = None  # LOD representatives: height ramp
        written.append(
            render_to(os.path.join(args.out, f"orbit{k:03d}.png"), view, pose, vcolors)
        )
    if args.animate > 0:
        max_frames = max(len(h) for h in histories)
        idxs = np.linspace(0, max_frames - 1, args.animate).astype(int)
        pose = render.orbit_pose(center, radius, 45.0)
        for j, fi in enumerate(idxs):
            ptsf = world_points(clouds, histories, int(fi))
            written.append(
                render_to(os.path.join(args.out, f"frame{j:03d}.png"), ptsf, pose)
            )
    print(f"wrote {len(written)} images to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
