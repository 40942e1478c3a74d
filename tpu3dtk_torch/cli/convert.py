"""``torchconvert`` — trajectory/pose format conversions and evaluation,
the port of ``tpuconvert``, covering the reference converter binaries
(frames2pose, pose2frames, frames2kitti, kitti2pose, frames2tum,
trajectoryLength, match_with_ground_truth, scan_diff, condense, atomize,
sICP, scan2features, graph_balancer; SURVEY §2.1).

    python -m tpu3dtk_torch.cli.convert scandiff -d 50 -o diff.3d DIR

Every subcommand takes ``--device``; those that compute on a device
(``scandiff``, ``scandiff2d``, ``condense -r``, ``sicp``,
``scan2features``) run on the first CUDA card unless it names another
(``--device cpu``).  The trajectory tools are host numpy."""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="torchconvert")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "--device", default=None,
        help="torch device: cuda[:N] or cpu (default: the first card)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, **kw):
        return sub.add_parser(name, parents=[common], **kw)

    s = add("frames2pose")
    s.add_argument("dir")
    s.add_argument("-o", "--out", default=None)

    s = add("pose2frames")
    s.add_argument("dir")
    s.add_argument("-o", "--out", default=None)

    s = add("frames2kitti")
    s.add_argument("dir")
    s.add_argument("-o", "--out", default="trajectory.kitti")

    s = add("kitti2pose")
    s.add_argument("kitti_file")
    s.add_argument("-o", "--out", default=".")

    s = add("frames2tum")
    s.add_argument("dir")
    s.add_argument("-o", "--out", default="trajectory.tum")

    s = add("trajectorylength")
    s.add_argument("dir")

    s = add("ate", help="absolute trajectory error between two .frames dirs")
    s.add_argument("dir_a")
    s.add_argument("dir_b")
    s.add_argument("--no-align", action="store_true")

    s = add("transformframes", help="left-multiply all frames by a 4x4 (ref transformFrames)")
    s.add_argument("dir")
    s.add_argument("matrix_file", help="file with 16 values (row-major 4x4)")
    s.add_argument("-o", "--out", default=None)

    s = add("multframes", help="re-anchor frames through a global matrix (ref multFrames)")
    s.add_argument("dir")
    s.add_argument("matrix_file")
    s.add_argument("-o", "--out", required=True)
    s.add_argument("--anchor", type=int, default=0)
    s.add_argument("--from-pose", action="store_true")

    s = add("average6dofposes", help="average 4x4 matrices from a file (ref average6DoFposes)")
    s.add_argument("matrix_file")

    s = add("frames2riegl")
    s.add_argument("dir")
    s.add_argument("-o", "--out", default=None)

    s = add("riegl2frames")
    s.add_argument("dir")
    s.add_argument("-o", "--out", default=None)

    s = add("scandiff", help="points of scan B not explained by scan A (ref scan_diff)")
    s.add_argument("dir")
    s.add_argument("-f", "--format", default="uos")
    s.add_argument("-a", "--id-a", type=int, default=0)
    s.add_argument("-b", "--id-b", type=int, default=1)
    s.add_argument("-d", "--dist", type=float, default=50.0)
    s.add_argument("-o", "--out", default="diff.3d")

    s = add("condense", help="merge groups of scans into metascans (ref condense)")
    s.add_argument("dir")
    s.add_argument("-f", "--format", default="uos")
    s.add_argument("--split", type=int, default=10)
    s.add_argument("-r", "--reduce", type=float, default=-1.0)
    s.add_argument("-o", "--out", default=None)
    s.add_argument("--use-frames", action="store_true")

    s = add("atomize", help="re-split condensed SLAM corrections (ref atomize)")
    s.add_argument("cond_dir")
    s.add_argument("orig_dir")
    s.add_argument("-f", "--format", default="uos")
    s.add_argument("--split", type=int, default=10)

    s = add(
        "frames2graph",
        help="final pose per scan as 'x y z qw qx qy qz' lines "
        "(ref frame_to_graph)",
    )
    s.add_argument("dir")
    s.add_argument("-s", "--start", type=int, default=0)
    s.add_argument("-e", "--end", type=int, default=-1)
    s.add_argument("-o", "--out", required=True)

    s = add(
        "convergence",
        help="per-frame pose evolution of one scan (ref convergence)",
    )
    s.add_argument("dir")
    s.add_argument("-s", "--scan", type=int, default=0)
    s.add_argument("-z", "--ctype", choices=("global", "local"), default="global")
    s.add_argument("-o", "--out", default="convergence.dat")

    s = add(
        "graphbalancer",
        help="ELCH weight distribution over a .net pose graph "
        "(ref graph_balancer)",
    )
    s.add_argument("net_file")
    s.add_argument("-s", "--first", type=int, default=0)
    s.add_argument("-e", "--last", type=int, default=-1)
    s.add_argument("-o", "--out", default=None)

    s = add(
        "sicp",
        help="align from GIVEN correspondences, no NN search (ref sICP)",
    )
    s.add_argument("-g", "--global-file", required=True,
                   help="target points, one 'x y z' per line")
    s.add_argument("-l", "--local-file", required=True,
                   help="source points, row-matched to the target file")
    s.add_argument("-n", "--nrpoints", type=int, default=-1)
    s.add_argument("-a", "--algo", default="quat")

    s = add(
        "scandiff2d",
        help="top-down color-coded 2D scan difference image "
        "(ref scan_diff2d)",
    )
    s.add_argument("dir")
    s.add_argument("-f", "--format", default="uos")
    s.add_argument("-a", "--id-a", type=int, default=0)
    s.add_argument("-b", "--id-b", type=int, default=1)
    s.add_argument("-d", "--dist", type=float, default=50.0)
    s.add_argument("-o", "--out", default="diff2d.png")

    s = add(
        "scan2features",
        help="per-point normal+curvature feature files "
        "(ref scan2features)",
    )
    s.add_argument("dir")
    s.add_argument("-f", "--format", default="uos")
    s.add_argument("-r", "--reduce", type=float, default=10.0)
    s.add_argument("-K", "--knearest", type=int, default=20)
    s.add_argument("-o", "--out", default=None)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    from ..io import converters as cv

    if args.cmd == "frames2pose":
        print(f"{cv.frames_to_pose(args.dir, args.out)} pose files written")
    elif args.cmd == "pose2frames":
        print(f"{cv.pose_to_frames(args.dir, args.out)} frames files written")
    elif args.cmd == "frames2kitti":
        print(f"{cv.frames_to_kitti(args.dir, args.out)} poses -> {args.out}")
    elif args.cmd == "kitti2pose":
        print(f"{cv.kitti_to_poses(args.kitti_file, args.out)} pose files -> {args.out}")
    elif args.cmd == "frames2tum":
        print(f"{cv.frames_to_tum(args.dir, args.out)} poses -> {args.out}")
    elif args.cmd == "trajectorylength":
        print(f"trajectory length: {cv.trajectory_length(args.dir):.2f} cm")
    elif args.cmd == "ate":
        print(json.dumps(cv.ate(args.dir_a, args.dir_b, align=not args.no_align)))
    elif args.cmd == "transformframes":
        T = np.loadtxt(args.matrix_file).reshape(4, 4)
        print(f"{cv.transform_frames(args.dir, T, args.out)} frames files transformed")
    elif args.cmd == "multframes":
        T = np.loadtxt(args.matrix_file).reshape(4, 4)
        n = cv.mult_frames(
            args.dir, T, args.out, anchor=args.anchor, from_pose=args.from_pose
        )
        print(f"{n} frames files written -> {args.out}")
    elif args.cmd == "average6dofposes":
        mats = np.loadtxt(args.matrix_file).reshape(-1, 4, 4)
        avg = cv.average_pose_matrices(mats)
        print("\n".join(" ".join(f"{v:.9f}" for v in row) for row in avg))
    elif args.cmd == "frames2riegl":
        print(f"{cv.frames_to_riegl(args.dir, args.out)} .dat files written")
    elif args.cmd == "riegl2frames":
        print(f"{cv.riegl_to_frames(args.dir, args.out)} .frames files written")
    elif args.cmd == "scandiff":
        diff = cv.scan_diff(
            args.dir, args.format, args.id_a, args.id_b, args.dist, device=args.device
        )
        np.savetxt(args.out, diff, fmt="%.6f")
        print(f"{len(diff)} difference points -> {args.out}")
    elif args.cmd == "condense":
        from ..io.condense import condense

        n = condense(
            args.dir,
            args.format,
            split=args.split,
            voxel=args.reduce,
            out_dir=args.out,
            use_frames=args.use_frames,
            device=args.device,
        )
        print(f"{n} condensed scans written")
    elif args.cmd == "atomize":
        from ..io.condense import atomize

        n = atomize(args.cond_dir, args.orig_dir, args.format, split=args.split)
        print(f"{n} scans atomized")
    elif args.cmd == "frames2graph":
        n = cv.frames_to_graph(args.dir, args.out, args.start, args.end)
        print(f"{n} poses -> {args.out}")
    elif args.cmd == "convergence":
        rows = cv.convergence_trace(args.dir, args.scan, args.ctype)
        np.savetxt(args.out, rows, fmt="%.9f")
        print(f"{len(rows)} frames -> {args.out}")
    elif args.cmd == "graphbalancer":
        from ..models.elch import graph_balancer
        from ..models.graphslam import read_net_graph

        links = read_net_graph(args.net_file)
        n_scans = int(links.max()) + 1
        last = args.last if args.last >= 0 else n_scans - 1
        w = graph_balancer(
            [tuple(e) for e in links], [1.0] * len(links),
            args.first, last, n_scans,
        )
        out = args.out or args.net_file + ".weights"
        np.savetxt(out, w, fmt="%.9f")
        print(f"{n_scans} weights -> {out}")
    elif args.cmd == "sicp":
        g = np.loadtxt(args.global_file).reshape(-1, 3)
        l = np.loadtxt(args.local_file).reshape(-1, 3)
        T = cv.sicp_align(g, l, args.nrpoints, args.algo, device=args.device)
        print("\n".join(" ".join(f"{v:.9f}" for v in row) for row in T))
    elif args.cmd == "scandiff2d":
        img = cv.scan_diff2d(
            args.dir, args.out, args.format, args.id_a, args.id_b, args.dist,
            device=args.device,
        )
        print(f"{img.shape[1]}x{img.shape[0]} diff image -> {args.out}")
    elif args.cmd == "scan2features":
        n = cv.scan_to_features(
            args.dir, args.out, args.format, args.reduce, args.knearest,
            device=args.device,
        )
        print(f"{n} feature files written")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
