"""The port runs without JAX and without OpenCV: with ``import jax`` and
``import cv2`` made impossible, the package, its slice modules, the CLI
parsers and the interop converters still import and work.  Without a
CUDA card the package's default device raises: the CPU is only used
when it is asked for."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["cv2"] = None
import tpu3dtk_torch
from tpu3dtk_torch import interop, synth
from tpu3dtk_torch.cli import slam6d
from tpu3dtk_torch.core import math3d, scan
from tpu3dtk_torch.io import cache, scandir, writer
from tpu3dtk_torch.models import graphslam, icp, minimizers, sequence
from tpu3dtk_torch.models import elch, graph_pipeline, lum_device
from tpu3dtk_torch.models import graphslam_variants, pgsolve
from tpu3dtk_torch.ops import cuda_build, knn, nn, nn_cuda, normals, reduction
from tpu3dtk_torch.ops import nn_cell_list, nn_cell_list_cuda
from tpu3dtk_torch.tools import kernel_tuning
from tpu3dtk_torch.io import boctree
from tpu3dtk_torch.models import sc_fixed, srr, streaming, subgraph
from tpu3dtk_torch.cli import icp_fixpoint
from tpu3dtk_torch.cli import calc_normals, planes, preg6d as preg6d_cli, scan_red
from tpu3dtk_torch.io import hough_config
from tpu3dtk_torch.models import preg6d, shapes
from tpu3dtk_torch.ops import panorama, search
assert callable(shapes.detect_planes_rht) and callable(preg6d.plane_register)
assert callable(hough_config.load_hough_config) and callable(panorama.reduce_interpolate)
assert callable(search.fixed_range_search_along_dir) and callable(normals.knn_pca_features)
assert callable(interop.planes_from_numpy) and callable(interop.preg_params_from)
a = planes.build_parser().parse_args(["d", "-p", "sht", "-C", "h.cfg", "--device", "cpu"])
assert (a.plane_algo, a.config, a.device) == ("sht", "h.cfg", "cpu")
assert planes.build_parser().parse_args(["d"]).plane_algo == "rht"
a = preg6d_cli.build_parser().parse_args(["d", "--optimizer", "adadelta", "--device", "cpu"])
assert (a.optimizer, a.iter, a.max_planes, a.device) == ("adadelta", 50, 12, "cpu")
a = calc_normals.build_parser().parse_args(["d", "-g", "panorama", "--device", "cpu"])
assert (a.ntype, a.device) == ("panorama", "cpu")
a = scan_red.build_parser().parse_args(["d", "-r", "RANGE", "--device", "cpu"])
assert (a.reduction, a.width, a.height, a.device) == ("RANGE", 3600, 1000, "cpu")
assert callable(boctree.write_oct) and callable(streaming.register_streaming)
assert callable(subgraph.subgraph_slam) and callable(srr.semi_rigid_registration)
assert callable(sc_fixed.icp_pair_fixed) and callable(interop.line_scan_set_from_numpy)
a = icp_fixpoint.build_parser().parse_args(["d", "--epsExp", "4", "--compare", "--device", "cpu"])
assert (a.epsExp, a.compare, a.device) == (4, True, "cpu")
a = slam6d.build_parser().parse_args(["d", "--cache-mb", "64", "--saveOct", "--loadOct"])
assert (a.cache_mb, a.save_oct, a.load_oct) == (64, True, True)
assert callable(icp.icp_pair_chained) and callable(synth.synth_city)
assert callable(graphslam.do_graph_slam) and callable(nn_cell_list.cell_list_rows)
assert callable(lum_device.lum_run) and callable(elch.close_loop)
assert callable(graph_pipeline.GraphPipeline().run) and callable(icp.icp_window_align)
assert callable(interop.corr_cache_from_numpy) and callable(graphslam.build_clpairs_graph)
assert set(graphslam_variants.GRAPHSLAM_VARIANTS) == {2, 3, 4} and set(elch.ELCH_VARIANTS) == {1, 2, 3, 4}
assert callable(pgsolve.solve_block_cg) and callable(normals.estimate_normals_knn)
assert callable(knn.knn_brute) and len(minimizers.MINIMIZERS) == 10
a = slam6d.build_parser().parse_args(["d", "-L", "2", "-G", "3", "-a", "10", "--plane", "--normalShoot"])
assert (a.loop6DAlgo, a.graphSlam6DAlgo, a.algo, a.point_to_plane, a.normal_shoot) == (2, 3, 10, True, True)
a = slam6d.build_parser().parse_args(["d", "-L", "4", "-G", "1", "--cldist", "300", "--loopsize", "10"])
assert (a.loop6DAlgo, a.graphSlam6DAlgo, a.cldist, a.loopsize) == (4, 1, 300.0, 10)
a = slam6d.build_parser().parse_args(["d", "-n", "g.net", "-I", "5", "-D", "150"])
assert a.net == "g.net" and a.iterSLAM == 5 and a.distSLAM == 150.0
p = slam6d.build_parser()
a = p.parse_args(["somewhere", "-r", "10", "--device", "cpu"])
assert a.reduce == 10.0 and a.device == "cpu"
from tpu3dtk_torch import native
from tpu3dtk_torch.cli import convert as convert_cli, export_points
from tpu3dtk_torch.io import condense, converters, e57, las, meshio, ply, png, velodyne
from tpu3dtk_torch.utils import config
assert callable(native.parse_table) and callable(config.parse_scan_ranges)
assert callable(las.write_las) and callable(e57.e57_to_scan) and callable(velodyne.decode_velodyne)
assert callable(ply.read_ply) and callable(png.read_png) and callable(meshio.write_ply_mesh)
assert callable(converters.scan_diff) and callable(condense.atomize)
assert callable(synth.velodyne_capture) and callable(synth.write_velodyne_dir)
a = convert_cli.build_parser().parse_args(["scandiff", "d", "-d", "25", "--device", "cpu"])
assert (a.cmd, a.dist, a.device) == ("scandiff", 25.0, "cpu")
a = convert_cli.build_parser().parse_args(["condense", "d", "--split", "5", "-r", "10", "--use-frames"])
assert (a.split, a.reduce, a.use_frames, a.device) == (5, 10.0, True, None)
subs = convert_cli.build_parser()._subparsers._group_actions[0].choices
assert len(subs) == 21, sorted(subs)
a = export_points.build_parser().parse_args(["d", "-r", "20", "-O", "0", "--device", "cpu"])
assert (a.reduce, a.octree, a.device) == (20.0, 0, "cpu")
from tpu3dtk_torch.cli import recon as recon_cli, veloslam as velo_cli
from tpu3dtk_torch.models import collision, mesh, peopleremover, segmentation, tracking, tsdf
from tpu3dtk_torch.models import veloslam
from tpu3dtk_torch.ops import surfacenets
assert callable(segmentation.graph_cut_segmentation) and callable(tracking.MultiObjectTracker)
assert callable(veloslam.VeloSlam) and callable(surfacenets.surface_nets)
assert callable(tsdf.TsdfVolume.for_bounds) and callable(mesh.reconstruct_poisson)
assert callable(peopleremover.remove_dynamic_points) and callable(collision.sweep_collisions)
assert callable(synth.velodyne_mover)
a = velo_cli.build_parser().parse_args(["d", "-f", "velodyne", "-T", "0", "--window", "4", "--device", "cpu"])
assert (a.format, a.tracking, a.window, a.dist, a.device) == ("velodyne", 0, 4, 25.0, "cpu")
a = recon_cli.build_parser().parse_args(["d", "--method", "tsdf", "--voxel", "8", "-K", "10", "--device", "cpu"])
assert (a.method, a.voxel, a.knearest, a.trunc, a.device) == ("tsdf", 8.0, 10, -1.0, "cpu")
assert interop.velo_params_from({"pad_multiple": 4096, "tracking": 1}).tracking == 1
assert interop.fh_params_from({"k": 6}).k == 6 and interop.tracker_params_from({}).max_misses == 3
assert interop.tsdf_params_from({"voxel": 8.0}).voxel == 8.0
assert interop.mesh_params_from({"k": 9}).k == 9 and interop.poisson_params_from({"grid": 32}).grid == 32
assert interop.people_remover_params_from({"maxrange_method": "normals"}).maxrange_method == "normals"
assert interop.collision_params_from({"radius": 5.0}).radius == 5.0
trk = interop.tracker_from_numpy({"params": {}, "next_id": 3, "tracks": []})
assert trk._next_id == 3 and trk.tracks == []
import numpy as np
vol = interop.tsdf_volume_from_numpy({"params": {}, "origin": np.zeros(3), "dims": (2, 2, 2),
                                      "tsdf": np.ones((2, 2, 2)), "weight": np.zeros((2, 2, 2))})
assert vol.dims == (2, 2, 2) and str(vol.device) == "cpu"
from tpu3dtk_torch.models import building, calibration, curvefusion, cylinder, fbr
from tpu3dtk_torch.models import floorplan, gps, grid2d, thermo
from tpu3dtk_torch.ops import features, lines
assert callable(gps.latlon_to_utm) and callable(curvefusion.fuse_trajectories)
assert callable(thermo.colorize_scan) and callable(calibration.calibrate_from_chessboard_images)
assert callable(cylinder.detect_cylinders) and callable(building.build_model)
assert callable(grid2d.extract_gridlines) and callable(floorplan.extract_floorplan)
assert callable(fbr.register_fbr) and callable(lines.hough_lines_p)
assert callable(features.sift_detect_and_compute) and features.ORB_PATTERN.shape == (256, 4)
assert callable(synth.building_room)
assert interop.grid2d_params_from({"resolution": 5.0}).resolution == 5.0
g = interop.occupancy_grid_from_numpy({"origin": np.zeros(2), "resolution": 10.0,
                                       "hits": np.zeros((2, 3)), "visits": np.ones((2, 3))})
assert g.hits.dtype == np.int32 and g.occupancy.shape == (2, 3)
assert interop.floorplan_params_from({"min_votes": 9}).min_votes == 9
assert interop.cylinder_params_from({"knn": 8}).knn == 8
assert interop.fusion_params_from({"window": 6}).window == 6
cam = interop.camera_from_numpy({"fx": 1, "fy": 2, "cx": 3, "cy": 4, "width": 5, "height": 6})
assert cam.fy == 2.0 and cam.R.shape == (3, 3)
fp = interop.fbr_params_from({"detector": "sift", "panorama": {"width": 90, "height": 45}})
assert fp.detector == "sift" and fp.panorama.width == 90
lines_out = lines.hough_lines_p(np.eye(40, dtype=np.uint8) * 255, 1, np.pi / 180, 10, 10, 2)
assert lines_out.shape[1] == 4 and len(lines_out) >= 1
from tpu3dtk_torch.cli import show
from tpu3dtk_torch.ops import bkd, octree, render, sphquad
from tpu3dtk_torch.parallel import distributed, icp_shard, lum_shard, mesh as pmesh
assert callable(render.render_points) and callable(render.lod_select) and callable(bkd.BkdForest)
assert callable(octree.build_octree) and callable(sphquad.SphericalQuadtree)
assert callable(icp_shard.icp_pair_sharded) and callable(lum_shard.lum_run_sharded)
assert pmesh.default_points_mesh() is None and distributed.host_scan_range(5) == (0, 5)
assert not distributed.initialize() and pmesh.rank_range(7, 2, 1) == (4, 7)
a = show.build_parser().parse_args(["d", "--lod", "5000", "--color", "scan", "--device", "cpu"])
assert (a.lod, a.color, a.device, a.orbit) == (5000, "scan", "cpu", 4)
a = slam6d.build_parser().parse_args(["d", "--distributed"])
assert a.distributed
bad = [m for m in sys.modules if m == "tpu3dtk" or m.startswith("tpu3dtk.")
       or ((m.startswith("jax") or m.startswith("cv2")) and sys.modules[m] is not None)]
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    import numpy as np
    import pytest
    import torch

    import tpu3dtk_torch
    from tpu3dtk_torch.cli import slam6d
    from tpu3dtk_torch.models import graphslam
    from tpu3dtk_torch.models.sequence import SequenceRegistration
    from tpu3dtk_torch.ops import nn_cell_list, reduction

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tpu3dtk_torch.default_device()
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reduction.reduce_scan(pts, 10.0, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SequenceRegistration()._device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nn_cell_list.nn_cell_list(pts, np.ones(4, bool), pts, np.ones(4, bool), 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graphslam._do_graph_slam_host([], np.zeros((1, 2), np.int32), graphslam.LumParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graphslam._do_graph_slam_device([], np.zeros((1, 2), np.int32), graphslam.LumParams())
    from tpu3dtk_torch.models import elch, lum_device
    from tpu3dtk_torch.models.graph_pipeline import GraphPipeline

    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphPipeline().run([None])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lum_device.CorrCache(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elch._edge_covariances_euler([], [], elch.ElchParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graphslam.build_clpairs_graph([], 1.0, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slam6d.main([str(tmp_path)])
    from tpu3dtk_torch.core.scan import Scan
    from tpu3dtk_torch.models import graphslam_variants, pgsolve
    from tpu3dtk_torch.ops import normals

    two = [Scan.from_points(pts, f"{k:03d}") for k in range(2)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graphslam_variants.do_graph_slam_quat(two, np.array([[0, 1]]), graphslam.LumParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        normals.estimate_normals_knn(pts, np.ones(4, bool), np.zeros(3, np.float32))
    from tpu3dtk_torch.cli import show
    from tpu3dtk_torch.ops import bkd, render

    with pytest.raises(RuntimeError, match="no CUDA device"):
        render.render_points(pts, np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bkd.BkdForest(pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        show.main([str(tmp_path), "-o", str(tmp_path / "out")])
    C = np.tile(np.eye(6), (1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pgsolve.solve_block_cg(np.array([[0, 1]]), C, np.ones((1, 6)), 1)
    from tpu3dtk_torch.cli import icp_fixpoint
    from tpu3dtk_torch.models import sc_fixed, srr, streaming, subgraph

    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.register_streaming(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        subgraph.subgraph_slam(two)
    lines = srr.LineScanSet.from_lists([pts, pts], np.tile(np.eye(4), (2, 1, 1)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srr.pre_registration(lines, (0, 0), (1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srr.semi_rigid_registration(lines, srr.SrrParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc_fixed.compare_fixed_float(pts, pts, np.eye(4), 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        icp_fixpoint.main([str(tmp_path)])
    from tpu3dtk_torch.cli import calc_normals, planes, preg6d as preg6d_cli, scan_red
    from tpu3dtk_torch.models import preg6d, shapes

    with pytest.raises(RuntimeError, match="no CUDA device"):
        shapes.detect_planes(pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shapes.detect_planes_rht(pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shapes.hough_accumulator(pts, shapes.HoughParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preg6d.preg6d(two)
    for est in (normals.estimate_normals_adaptive_knn, normals.estimate_normals_apx_knn):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            est(pts, np.ones(4, bool), np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        normals.estimate_normals_panorama(pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        normals.knn_pca_features(pts)
    for cli in (planes, preg6d_cli, calc_normals, scan_red):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([str(tmp_path)])
    from tpu3dtk_torch.cli import convert as convert_cli, export_points
    from tpu3dtk_torch.io import condense, converters

    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_points.main([str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        converters.scan_diff_found(pts, pts, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        converters.sicp_align(pts, pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        converters.scan_to_features(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        condense.condense(str(tmp_path), voxel=10.0)
    np.savetxt(tmp_path / "pairs.txt", np.eye(3) * 100.0)
    pairs = str(tmp_path / "pairs.txt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_cli.main(["sicp", "-g", pairs, "-l", pairs])
    from tpu3dtk_torch.cli import recon as recon_cli, veloslam as velo_cli
    from tpu3dtk_torch.models import collision, mesh, peopleremover, segmentation, tsdf, veloslam
    from tpu3dtk_torch.ops import surfacenets

    for fn in (
        lambda: segmentation.fh_segmentation(pts),
        lambda: segmentation.region_growing_segmentation(pts),
        lambda: veloslam.VeloSlam().process_scan(two[0]),
        lambda: surfacenets.surface_nets(np.ones((2, 2, 2))),
        lambda: tsdf.TsdfVolume(np.zeros(3), (2, 2, 2)),
        lambda: mesh.imls_field(pts, pts),
        lambda: mesh.poisson_field(pts, pts),
        lambda: peopleremover.remove_dynamic_points([pts], [np.zeros(3)]),
        lambda: collision.detect_collisions(pts, pts, np.eye(4)[None]),
        lambda: collision.sweep_collisions(pts, pts, 1.0),
        lambda: velo_cli.main([str(tmp_path)]),
        lambda: recon_cli.main([str(tmp_path)]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert SequenceRegistration(device="cpu")._device() == torch.device("cpu")
