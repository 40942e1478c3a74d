"""``torchslam`` — the port of ``tpuslam`` (``tpu3dtk.cli.slam6d``), the
reference ``slam6D`` driver's flags (src/slam6d/slam6D.cc:158-367), on
PyTorch and CUDA.

Ported: sequential ICP registration (the default path); with -n/--net
or -C/--clpairs, LUM over an explicit or a shared-pairs pose graph after
it (the bremen_city workflow); with -L 1..4 and/or -G 1..4 the full
GraphPipeline (loop detection, ELCH closure, GraphSLAM relaxation); with
--cache-mb out-of-core window-1 sequential ICP (``models.streaming``).
Flags:
  -s/--start -e/--end --scans  scan range
  -f/--format          scan format (uos, uosr, xyz, ...; text formats)
  -m/--max -M/--min -u range and custom point filters (cm)
  -r/--reduce          voxel reduction voxel size
  -O/--octree          pts per voxel (0 center, -1 mean, n random)
  -R/--random          per-iteration random point subsampling
  -d/--dist            ICP max match distance (cm)
  -i/--iter            max ICP iterations
  --epsICP             ICP convergence epsilon
  -a/--algo            minimizer 1 quat, 2 svd, 3 ortho, 4 dual, 5 helix,
                       6 apx, 7 lumeuler, 8 lumquat, 9 quatscale, 10 napx
  --plane              point-to-plane pairing (target normals)
  --normalShoot        normal-shooting pairing (along the target normals)
  --metascan           match against union of previous scans
  -n/--net             explicit .net pose graph: LUM over its links
  -C/--clpairs         LUM over the graph of scan pairs sharing >= N pairs
  -L/--loop6DAlgo      ELCH loop closing: 1 euler, 2 quat, 3 unitQuat,
                       4 slerp (GraphPipeline)
  -G/--graphSlam6DAlgo GraphSLAM: 1 lum6DEuler, 2 lum6DQuat, 3 ghelix6DQ2,
                       4 gapx6D (GraphPipeline)
  --cldist --loopsize  loop detection distance (cm) and minimum loop length
  -I/--iterSLAM -D/--distSLAM --epsSLAM  LUM iterations, distance, epsilon
  --cache-mb N         stream the scans through an N MiB LRU cache of
                       reduced clouds (only -d, -i and --epsICP reach
                       the streaming ICP, as in the JAX package: -a, -R
                       and --metascan are ignored there)
  --saveOct --loadOct  write each scan's reduced points as a
                       show-compatible scan<id>.oct (voxel -r or 10)
                       into the frames directory after the run; read
                       <dir>/scan<id>.oct, where one exists, in place
                       of the reduction
  --distributed        one of NPROC processes (JAX_COORDINATOR, NPROC,
                       PROC_ID, as for tpuslam; parallel.distributed):
                       each reads and reduces its range of the scans, the
                       sequential matching runs whole on every process,
                       the LUM links are split over the processes; process
                       0 writes the .frames
  --frames-out --continue --prefetch --exportAllPoints -q
  --device             cuda[:N] | cpu (default: the first card; without a
                       card the run stops unless --device cpu is given)

A value of -a outside 1..10 or of -L / -G outside 0..4 stops with an
error (the JAX package's tpuslam quietly takes quat for such an -a).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ALGO_NAMES = {
    1: "quat", 2: "svd", 3: "ortho", 4: "dual", 5: "helix",
    6: "apx", 7: "lumeuler", 8: "lumquat", 9: "quatscale", 10: "napx",
}

# flag -> (its value, the values slam6D defines for it)
_RANGES = (
    ("-a/--algo", lambda a: a.algo, range(1, 11)),
    ("-L/--loop6DAlgo", lambda a: a.loop6DAlgo, range(0, 5)),
    ("-G/--graphSlam6DAlgo", lambda a: a.graphSlam6DAlgo, range(0, 5)),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="torchslam",
        description="6D SLAM on PyTorch/CUDA (capabilities of 3DTK slam6D)",
    )
    p.add_argument("dir", help="scan directory")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=-1)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-M", "--min", type=float, default=-1, dest="min_range")
    p.add_argument(
        "-u", "--customFilter", default=None, dest="custom_filter",
        help="custom point-filter DSL '{mode};{n}[;params...]/...' "
        "(ref pointfilter.cc CheckerCustom modes 0/1/2/10/11/20/21/22)",
    )
    p.add_argument(
        "--scans", default=None,
        help="scan range-set DSL 'a:b,c:step:d,$' (ref scan_settings "
        "range parser); overrides -s/-e",
    )
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument("-R", "--random", type=int, default=-1)
    p.add_argument("-d", "--dist", type=float, default=25.0)
    p.add_argument("-i", "--iter", type=int, default=50)
    p.add_argument("--epsICP", type=float, default=1e-5)
    p.add_argument("-a", "--algo", type=int, default=1)
    p.add_argument("--metascan", action="store_true")
    p.add_argument("-G", "--graphSlam6DAlgo", type=int, default=0)
    p.add_argument("-I", "--iterSLAM", type=int, default=50)
    p.add_argument("-D", "--distSLAM", type=float, default=25.0)
    p.add_argument("--epsSLAM", type=float, default=0.5)
    p.add_argument("-C", "--clpairs", type=int, default=-1)
    p.add_argument("-L", "--loop6DAlgo", type=int, default=0)
    p.add_argument("--cldist", type=float, default=500.0)
    p.add_argument("--loopsize", type=int, default=20)
    p.add_argument("-n", "--net", default=None, help="explicit .net pose-graph file")
    p.add_argument("--plane", dest="point_to_plane", action="store_true")
    p.add_argument("--normalShoot", dest="normal_shoot", action="store_true")
    p.add_argument("--cache-mb", type=int, default=0)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--exportAllPoints", action="store_true")
    p.add_argument("--frames-out", default=None, help="directory for .frames (default: scan dir)")
    p.add_argument(
        "--continue", dest="continue_processing", action="store_true",
        help="resume from existing .frames (ref slam6D --continue)",
    )
    p.add_argument(
        "--prefetch", type=int, default=2,
        help="scans to read ahead in background threads (0 disables)",
    )
    p.add_argument("--saveOct", dest="save_oct", action="store_true")
    p.add_argument("--loadOct", dest="load_oct", action="store_true")
    p.add_argument("--distributed", action="store_true")
    p.add_argument(
        "--device", default=None,
        help="torch device to run on: cuda[:N] or cpu (default: the first "
        "CUDA card; without a card the run stops with an error unless "
        "--device cpu is given)",
    )
    return p


def _load_scan(raw, args, device):
    """A scan of the directory with its reduction set, its ``--loadOct``
    points and its ``--continue`` pose."""
    from ..core.scan import Scan
    from ..io import frames as frames_io
    from ..io.boctree import read_oct

    s = Scan.from_raw(raw, device=str(device))
    s.set_reduction(args.reduce, args.octree if args.reduce > 0 else 0)
    if args.load_oct:
        op = os.path.join(args.dir, f"scan{s.identifier}.oct")
        if os.path.exists(op):
            s.load_reduced(read_oct(op))
    if args.continue_processing:
        # resume from the last .frames pose (ref slam6D.cc:628,
        # Scan::continueProcessing, basicScan.cc:902-945)
        fp = frames_io.frames_path(args.dir, s.identifier)
        if os.path.exists(fp):
            T = frames_io.final_pose(fp)
            s.transMat = np.asarray(T)
            s.transMatOrg = np.asarray(T)
            s.dalignxf = np.eye(4)
    return s


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, value, valid in _RANGES:
        if value(args) not in valid:
            parser.error(
                f"{flag} {value(args)} is not a slam6D choice "
                f"({valid.start}..{valid.stop - 1})"
            )

    import torch

    from .. import default_device
    from ..io import frames as frames_io
    from ..io.scandir import PointFilter, read_scan_dir
    from ..models.icp import IcpParams
    from ..models.sequence import SequenceRegistration
    from ..utils.metrics import MATCHING, SCAN_LOAD, metrics

    device = torch.device(args.device) if args.device else default_device()
    dist = lum_group = None
    if args.distributed:
        from ..parallel import distributed as dist

        dist.initialize(device=device)
        device = dist.rank_device(device)
        # matching runs whole on every process (a per-iteration sum over
        # processes would be latency-bound); the LUM links are split
        lum_group = dist.host_device_mesh()
    pf = PointFilter(
        range_max=args.max_range if args.max_range > 0 else None,
        range_min=args.min_range if args.min_range > 0 else None,
        custom=args.custom_filter,
    )
    if args.cache_mb > 0:
        # out-of-core streaming mode (the scanserver role): scans page
        # through an LRU byte budget; sequential matching only, with the
        # JAX package's IcpParams (-d, -i, --epsICP; quat)
        from ..models.streaming import register_streaming

        results = register_streaming(
            args.dir, format=args.format,
            params=IcpParams(
                max_dist_match2=args.dist**2, max_iterations=args.iter,
                epsilon=args.epsICP,
            ),
            point_filter=pf,
            reduction=(args.reduce, args.octree if args.reduce > 0 else 0),
            cache_bytes=args.cache_mb << 20,
            frames_out=args.frames_out or args.dir,
            start=args.start, end=args.end,
            device=device,
        )
        if not args.quiet:
            for r in results[1:]:
                print(
                    f"scan {r['identifier']}: ITER {r['iterations']} "
                    f"err {r['error']:.4f}"
                )
        return 0
    if args.scans:
        # range-set DSL selection: expand against the directory and
        # narrow [start, end]; the stepped subset is applied after load
        from ..io.scandir import expand_range_set, get_format, list_identifiers

        spec_fmt = get_format(args.format)
        avail = [int(i) for i in list_identifiers(args.dir, spec_fmt, 0, -1)]
        selected = set(expand_range_set(args.scans, avail))
        if selected:
            args.start = min(selected)
            args.end = max(selected)
    else:
        selected = None
    with metrics.time(SCAN_LOAD):
        if args.distributed:
            scans = dist.distributed_ingest(
                args.dir, format=args.format, start=args.start,
                end=args.end, point_filter=pf, reduce_voxel=args.reduce,
                octree_n=args.octree if args.reduce > 0 else 0,
                mesh=lum_group, device=device,
            )
        else:
            if args.prefetch > 0:
                from ..io.cache import prefetch_scans

                raw_iter = prefetch_scans(
                    args.dir, format=args.format, start=args.start,
                    end=args.end, point_filter=pf, lookahead=args.prefetch,
                )
            else:
                raw_iter = read_scan_dir(
                    args.dir, format=args.format, start=args.start,
                    end=args.end, point_filter=pf,
                )
            scans = [_load_scan(raw, args, device) for raw in raw_iter
                     if selected is None or int(raw.identifier) in selected]
    if not scans:
        print(f"no scans found in {args.dir}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"loaded {len(scans)} scans from {args.dir} (device {device})")

    pairing = "closest_point"
    if args.point_to_plane:
        pairing = "closest_plane"  # ref slam6D.cc:361
    if args.normal_shoot:
        pairing = "along_normal"  # ref slam6D.cc:362
    params = IcpParams(
        max_dist_match2=args.dist**2,
        max_iterations=args.iter,
        epsilon=args.epsICP,
        minimizer=ALGO_NAMES[args.algo],
        subsample=max(args.random, 1),
        pairing=pairing,
    )
    out_dir = args.frames_out or args.dir

    def save_frames():
        """Persist pose logs; also invoked on interrupt so a partial
        registration survives (ref slam6D.cc:92-112 signal handler).
        Distributed: process 0 writes (the poses are the same on every
        process)."""
        if lum_group is not None and torch.distributed.get_rank(lum_group) != 0:
            return
        try:
            for s in scans:
                if not s.frames:
                    continue
                mats = np.stack([f[0] for f in s.frames])
                types = [f[1] for f in s.frames]
                frames_io.write_frames(
                    frames_io.frames_path(out_dir, s.identifier), mats, types
                )
        except OSError as e:
            print(f"cannot write .frames to {out_dir}: {e}", file=sys.stderr)

    import signal

    def on_signal(signum, frame):
        print(f"signal {signum}: saving .frames before exit", file=sys.stderr)
        save_frames()
        raise SystemExit(128 + signum)

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, on_signal)
        except ValueError:
            pass  # not the main thread

    def sequential():
        return SequenceRegistration(
            params=params, metascan=args.metascan, device=device
        ).run(scans)

    def lum_params():
        from ..models import graphslam as gs

        return gs.LumParams(
            max_dist_match2=(
                args.distSLAM**2 if args.distSLAM > 0 else args.dist**2
            ),
            iterations=args.iterSLAM,
            epsilon=args.epsSLAM,
            device=device,
            group=lum_group,
        )

    t0 = time.perf_counter()
    with metrics.time(MATCHING):
        if args.net:
            # explicit .net graph: sequential ICP, then LUM over the
            # given links (bremen_city workflow)
            from ..models import graphslam as gs

            results = sequential()
            gs.do_graph_slam(scans, gs.read_net_graph(args.net), lum_params())
        elif args.clpairs > -1:
            # ref slam6D.cc:767-779: sequential ICP, then LUM over the
            # shared-pairs graph
            from ..models import graphslam as gs

            results = sequential()
            links = gs.build_clpairs_graph(
                scans, args.dist**2, args.clpairs, device=device
            )
            if len(links):
                gs.do_graph_slam(scans, links, lum_params())
        elif args.graphSlam6DAlgo > 0 or args.loop6DAlgo > 0:
            from ..models.graph_pipeline import GraphPipeline

            results = GraphPipeline(
                icp_params=params,
                metascan=args.metascan,
                lum_max_dist2=args.distSLAM**2 if args.distSLAM > 0 else args.dist**2,
                lum_iterations=args.iterSLAM,
                lum_epsilon=args.epsSLAM,
                elch=args.loop6DAlgo > 0,
                elch_algo=args.loop6DAlgo,
                cldist=args.cldist,
                loopsize=args.loopsize,
                slam_algo=max(args.graphSlam6DAlgo, 1),
                device=device,
                lum_group=lum_group,
            ).run(scans)
        else:
            results = sequential()
    dt = (time.perf_counter() - t0) * 1000.0
    if not args.quiet:
        for r in results:
            print(
                f"scan {r['identifier']}: ITER {r['iterations']} "
                f"err {r['error']:.4f} pairs {r['pairs']}"
            )
    # ref slam6D.cc:874-875
    print(f"Matching done in {dt:.0f} milliseconds!!!")

    save_frames()

    if args.save_oct:
        from ..io.boctree import write_oct

        voxel = args.reduce if args.reduce > 0 else 10.0
        for s in scans:
            write_oct(
                os.path.join(out_dir, f"scan{s.identifier}.oct"),
                s.reduced_local(), voxel,
            )

    if args.exportAllPoints:
        from ..io.writer import write_uos

        pts = np.concatenate([s.points_global() for s in scans], axis=0)
        write_uos(os.path.join(out_dir, "points.pts"), pts)

    if not args.quiet:
        print(metrics.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
