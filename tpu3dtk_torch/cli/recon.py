"""``torchrecon`` — surface reconstruction, the port of ``tpurecon`` (the
reference's ``bin/recon``, src/mesh/recon.cc: scans → Poisson → .obj, and
``bin/scan2tsdf`` + ``vdb2mesh``, src/tsdf/: scans → TSDF fusion → mesh).

    python -m tpu3dtk_torch.cli.recon -m 2500 -r 15 --method imls -o out.obj DIR
    python -m tpu3dtk_torch.cli.recon --method tsdf --voxel 8 -o out.ply DIR

Each scan takes its final pose from ``DIR``'s .frames file where there is
one.  The work runs on the first CUDA card unless ``--device`` names
another device (``--device cpu``); the volume or field is meshed where it
lives and only the mesh comes to the host.  The tsdf method prints the
volume's bytes; the counter ``imls_pairs`` and the span ``recon_time``
(``utils.metrics.metrics``) count the IMLS k-NN's pairs and time the
reconstruction from the first fused scan to the mesh.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

RECON = "recon_time"  # metrics timer: fusion / field solve + meshing


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="torchrecon",
        description="surface reconstruction (3DTK mesh/tsdf)",
    )
    p.add_argument("dir")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=-1)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument("--method", choices=("imls", "poisson", "tsdf"), default="imls")
    p.add_argument("--voxel", type=float, default=10.0)
    p.add_argument("--trunc", type=float, default=-1.0,
                   help="tsdf truncation (default 3*voxel)")
    p.add_argument("-K", "--knearest", type=int, default=12)
    p.add_argument("-o", "--out", default="mesh.obj",
                   help=".obj or .ply output path")
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
    from ..core import math3d
    from ..core.scan import Scan
    from ..io import frames as frames_io
    from ..io.meshio import write_obj, write_ply_mesh
    from ..io.scandir import PointFilter, read_scan_dir
    from ..utils.metrics import SCAN_LOAD, metrics

    device = torch.device(args.device) if args.device else default_device()
    pf = PointFilter(range_max=args.max_range if args.max_range > 0 else None)
    scans = []
    raws = iter(read_scan_dir(
        args.dir, format=args.format, start=args.start, end=args.end, point_filter=pf,
    ))
    while True:
        with metrics.time(SCAN_LOAD):
            raw = next(raws, None)
        if raw is None:
            break
        s = Scan.from_raw(raw, device=device)
        s.set_reduction(args.reduce, args.octree if args.reduce > 0 else 0)
        fp = frames_io.frames_path(args.dir, s.identifier)
        if os.path.exists(fp):
            s.set_pose(np.asarray(frames_io.final_pose(fp)), 2, record=False)
        scans.append(s)
    if not scans:
        print(f"no scans found in {args.dir}", file=sys.stderr)
        return 1

    allg = np.concatenate([
        np.asarray(math3d.transform3(s.transMat, s.reduced_local())) for s in scans
    ])
    with metrics.time(RECON):
        if args.method == "tsdf":
            from ..models.tsdf import TsdfParams, TsdfVolume

            trunc = args.trunc if args.trunc > 0 else 3 * args.voxel
            vol = TsdfVolume.for_bounds(
                allg.min(0), allg.max(0),
                TsdfParams(voxel=args.voxel, truncation=trunc), device=device,
            )
            if not args.quiet:
                print(f"tsdf volume {'x'.join(map(str, vol.dims))} voxels, {vol.nbytes} bytes")
            for s in scans:
                vol.integrate(np.asarray(s.reduced_local()), s.transMat)
                if not args.quiet:
                    print(f"fused scan {s.identifier}")
            verts, faces = vol.extract_mesh()
        elif args.method == "poisson":
            from ..models.mesh import PoissonParams, poisson_grid, reconstruct_poisson

            params = PoissonParams()
            if not args.quiet:
                print(f"poisson grid {params.grid}^3, voxel {poisson_grid(allg, params)[1]:.4f} cm, "
                      f"{len(allg)} points")
            verts, faces = reconstruct_poisson(allg, None, params, device=device)
        else:
            from ..models.mesh import MeshParams, imls_grid, reconstruct_imls

            params = MeshParams(voxel=args.voxel, k=args.knearest)
            if not args.quiet:
                dims = imls_grid(allg.astype(np.float32), params)[1]
                print(f"imls grid {'x'.join(map(str, dims))} nodes x {len(allg)} points = "
                      f"{int(np.prod(dims)) * len(allg):.4g} pairs")
            verts, faces = reconstruct_imls(allg, None, params, device=device)
    if args.out.endswith(".ply"):
        write_ply_mesh(args.out, verts, faces)
    else:
        write_obj(args.out, verts, faces)
    print(f"{len(verts)} vertices, {len(faces)} triangles -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
