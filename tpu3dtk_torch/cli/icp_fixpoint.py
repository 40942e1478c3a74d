"""``torchicpfixpoint`` — the port of ``tpuicpfixpoint``
(``tpu3dtk.cli.icp_fixpoint``), counterpart of the reference
``bin/icpFixpoint`` (src/slam6d/icpFixpoint.cc): sequential matching
through the quantized datapath (``models.sc_fixed``: bf16 ranking, a
10^-exp epsilon) with, on ``--compare``, a per-scan comparison against
the exact pipeline.  The same flags and per-scan output as
``tpuicpfixpoint``, plus ``--device`` (default: the first CUDA card;
without a card the run stops unless ``--device cpu`` is given).

As in the JAX package, ``--compare`` hands the harness each pair
padded to a multiple of 512 points with every point unmasked: the
padding zeros take part in both of its runs.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="torchicpfixpoint",
        description="reduced-precision (bf16) sequential ICP (3DTK icpFixpoint) "
        "on PyTorch/CUDA",
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
        "--epsExp", type=int, default=3,
        help="epsilon = 10^-exp termination (ref epsilonICPexp)",
    )
    p.add_argument(
        "--compare", action="store_true",
        help="also run the exact pipeline and report pose deltas",
    )
    p.add_argument("--frames-out", default=None)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument(
        "--device", default=None,
        help="torch device to run on: cuda[:N] or cpu (default: the first "
        "CUDA card; without a card the run stops with an error unless "
        "--device cpu is given)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .. import default_device
    from ..core import math3d
    from ..core.scan import Scan
    from ..io import frames as frames_io
    from ..io.frames import AlgoType
    from ..io.scandir import PointFilter, read_scan_dir
    from ..models.sc_fixed import compare_fixed_float, icp_pair_fixed

    device = torch.device(args.device) if args.device else default_device()
    pf = PointFilter(
        range_max=args.max_range if args.max_range > 0 else None
    )
    scans = []
    for raw in read_scan_dir(
        args.dir, format=args.format, start=args.start, end=args.end,
        point_filter=pf,
    ):
        s = Scan.from_raw(raw, device=str(device))
        s.set_reduction(args.reduce, args.octree if args.reduce > 0 else 0)
        scans.append(s)
    if len(scans) < 2:
        print("need at least two scans", file=sys.stderr)
        return 1

    cap = max(len(s.reduced_local()) for s in scans)
    cap = ((cap + 511) // 512) * 512
    md2 = args.dist**2

    def padded(pts):
        out = np.zeros((cap, 3), np.float32)
        out[: len(pts)] = pts
        mask = np.zeros(cap, bool)
        mask[: len(pts)] = True
        return out, mask

    def on_device(a):
        return torch.as_tensor(a, device=device)

    for i in range(1, len(scans)):
        prev, cur = scans[i - 1], scans[i]
        mp, mm = padded(math3d.transform3(prev.transMat, prev.reduced_local(), xp=np))
        tp, tm = padded(cur.reduced_local())
        res = icp_pair_fixed(
            on_device(mp), on_device(mm), on_device(tp), on_device(tm),
            on_device(cur.transMat.astype(np.float32)), md2,
            max_iterations=args.iter, eps_exp=args.epsExp,
        )
        T = res.T.cpu().numpy().astype(np.float64)
        u, _, vt = np.linalg.svd(T[:3, :3])
        T[:3, :3] = u @ vt
        if args.compare:
            cmpres = compare_fixed_float(
                mp, tp, cur.transMat.astype(np.float32), md2, device=device,
                max_iterations=args.iter, eps_exp=args.epsExp,
            )
            if not args.quiet:
                print(
                    f"scan {cur.identifier}: bf16-vs-f32 delta "
                    f"{cmpres['delta_translation_cm']:.4f} cm"
                )
        cur.set_pose(T, AlgoType.ICP)
        if not args.quiet:
            print(
                f"scan {cur.identifier}: ITER {int(res.iterations)} "
                f"err {float(res.error):.4f} pairs {int(res.n_pairs)}"
            )

    out_dir = args.frames_out or args.dir
    for s in scans:
        if not s.frames:
            s.add_frame(AlgoType.ICP)
        mats = np.stack([f[0] for f in s.frames])
        types = [f[1] for f in s.frames]
        frames_io.write_frames(
            frames_io.frames_path(out_dir, s.identifier), mats, types
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
