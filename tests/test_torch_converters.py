"""The port's converters (``io.converters``, ``io.condense``) and its two
tools (``torchconvert``, ``torchexport``) against the JAX package's
(``tpuconvert``, ``tpuexport``), on the same numpy inputs made from a
seed, on the CPU (``device="cpu"`` / ``--device cpu``).

Bounds:
- ``scan_diff``: the same point set, except points whose d² lies within
  1e-2 cm² of ``max_dist²`` (the JAX package ranks on the
  |q|²+|m|²−2q·m expansion, the port on direct differences; both accept
  on the recomputed f32 d²).  Where that band is empty, the diff file
  and ``scan_diff2d``'s PNG are byte-identical.
- ``sicp_align``: the rotation within 1e-6, the translation within 1e-4
  cm.  Both packages reduce the pairs in f32, in different orders: at a
  translation of 80 cm one f32 spacing is 7.6e-6 cm, and the two differ
  by 3.8e-6 to 7.6e-5 cm over the seven minimizers (quatscale's scale
  factor the most), so 1e-5 cm would hold only to one spacing.
- ``scan_to_features`` (``reduce_voxel`` ≤ 0): the points' text columns
  identical, ≥ 99% of the normals within 1°, curvature within 1e-4.
- ``condense`` / ``atomize``: metascan points within 1e-4 cm (voxel
  centres in f32 in both), pose files byte-identical, atomized frames
  within 1e-9.
- ``torchconvert``: each of the 21 subcommands against ``tpuconvert``:
  byte-identical files (frames, poses, kitti, tum, riegl, graph,
  convergence, weights), the same printed numbers (sicp's printed
  matrix within 1e-4, as above).
- ``torchexport``: ``-r -1`` byte-identical; ``-r 20 -O 0`` within
  1e-3 cm.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from tests.conftest import make_room_cloud
from tpu3dtk.cli import convert as jconvert
from tpu3dtk.cli import export_points as jexport
from tpu3dtk.io import condense as jcond
from tpu3dtk.io import converters as jcv
from tpu3dtk_torch import synth
from tpu3dtk_torch.cli import convert as tconvert
from tpu3dtk_torch.cli import export_points as texport
from tpu3dtk_torch.core import math3d
from tpu3dtk_torch.io import condense as tcond
from tpu3dtk_torch.io import converters as tcv
from tpu3dtk_torch.io import frames as frames_io

MAX_DIST = 25.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """Six scans of a loop (1500 points each) as a uos directory at the
    odometry poses, with frames holding an ICP history and the true pose
    last."""
    d = tmp_path_factory.mktemp("seq")
    locals_, true_mats, odo_mats = synth.synth_loop(n_scans=6, n_pts=1500, seed=3)
    scan_dir = str(d / "scans")
    idents = synth.write_scan_dir(scan_dir, locals_, odo_mats)
    for i, (T, To) in zip(idents, zip(true_mats, odo_mats)):
        frames_io.write_frames(frames_io.frames_path(scan_dir, i),
                               np.stack([To, 0.5 * (T + To), T]), [1, 1, 3])
    return scan_dir, np.stack(true_mats), np.stack(odo_mats)


def _boundary_band(scan_dir, max_dist):
    """Points of scan 1 (global f32) whose exact f64 nearest d² to scan 0
    lies within 1e-2 cm² of max_dist², and the global clouds."""
    a = tcv.registered_points(scan_dir, "uos", 0).astype(np.float32)
    b = tcv.registered_points(scan_dir, "uos", 1).astype(np.float32)
    d, _ = cKDTree(a.astype(np.float64)).query(b.astype(np.float64))
    return np.abs(d**2 - max_dist**2) <= 1e-2, a, b


def test_scan_diff_matches_jax(seq):
    scan_dir, *_ = seq
    band, _a, b = _boundary_band(scan_dir, MAX_DIST)
    t = tcv.scan_diff(scan_dir, "uos", 0, 1, MAX_DIST, device="cpu")
    j = jcv.scan_diff(scan_dir, "uos", 0, 1, MAX_DIST)
    assert t.dtype == np.float32 and 0 < len(t) < len(b)
    ts = {tuple(p) for p in t}
    js = {tuple(p) for p in j}
    near = {tuple(p) for p in b[band]}
    assert ts - near == js - near
    # without frames the .pose files place the scans
    t = tcv.scan_diff(scan_dir, "uos", 0, 1, MAX_DIST, use_frames=False, device="cpu")
    j = jcv.scan_diff(scan_dir, "uos", 0, 1, MAX_DIST, use_frames=False)
    assert len(t) > 0 and {tuple(p) for p in t} == {tuple(p) for p in j}


def test_scan_diff_found_is_strict_at_the_boundary():
    q = np.array([[0.0, 0.0, 0.0], [100.0, 0.0, 0.0]], np.float32)
    m = np.array([[10.0, 0.0, 0.0], [100.0, 0.0, 10.0]], np.float32)
    assert tcv.scan_diff_found(m, q, 10.0, "cpu").tolist() == [False, False]
    assert tcv.scan_diff_found(m, q, 10.001, "cpu").tolist() == [True, True]


def test_scan_diff2d_matches_jax(seq, tmp_path):
    scan_dir, *_ = seq
    band, *_ = _boundary_band(scan_dir, MAX_DIST)
    assert not band.any()
    t = tcv.scan_diff2d(scan_dir, str(tmp_path / "t.png"), "uos", 0, 1, MAX_DIST, width=300,
                        device="cpu")
    j = jcv.scan_diff2d(scan_dir, str(tmp_path / "j.png"), "uos", 0, 1, MAX_DIST, width=300)
    np.testing.assert_array_equal(t, j)
    assert (t == [255, 32, 32]).all(-1).any()
    assert _bytes(tmp_path / "t.png") == _bytes(tmp_path / "j.png")


@pytest.mark.parametrize("minimizer", ["quat", "svd", "ortho", "dual", "helix", "apx", "quatscale"])
def test_sicp_align_matches_jax(minimizer):
    rng = np.random.default_rng(13)
    g = rng.uniform(-2000, 2000, (5000, 3))
    T = np.asarray(math3d.euler_to_matrix4(np.array([35.0, -12.0, 80.0]), np.array([0.05, -0.2, 0.1])))
    loc = np.asarray(math3d.transform3(np.linalg.inv(T), g)) + rng.normal(0, 1.0, g.shape)
    t = tcv.sicp_align(g, loc, minimizer=minimizer, device="cpu")
    j = jcv.sicp_align(g, loc, minimizer=minimizer)
    np.testing.assert_allclose(t[:3, 3], j[:3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t[:3, :3], j[:3, :3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t[:3, :3] @ t[:3, :3].T, np.eye(3), atol=1e-12)
    if minimizer not in ("helix", "apx"):  # one linearised step each, not exact
        np.testing.assert_allclose(t[:3, 3], T[:3, 3], atol=0.1)
    tn = tcv.sicp_align(g, loc, n_use=100, minimizer=minimizer, device="cpu")
    jn = jcv.sicp_align(g, loc, n_use=100, minimizer=minimizer)
    np.testing.assert_allclose(tn[:3, 3], jn[:3, 3], rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        tcv.sicp_align(g[:2], loc[:2], device="cpu")


def _room_dir(root, n_scans=2, n=1800):
    """A noisy 300 cm room around the scanner: one scan per pose, 1 cm
    noise (the lattice ties of reduced clouds rank differently in the
    two packages, so the features compare on unreduced points)."""
    rng = np.random.default_rng(14)
    cloud = make_room_cloud(rng, n=n, size=300.0) - 150.0
    locals_, poses = [], []
    for k in range(n_scans):
        T = np.asarray(math3d.euler_to_matrix4(np.array([5.0 * k, 0.0, 0.0]), np.zeros(3)))
        local = np.asarray(math3d.transform3(np.linalg.inv(T), cloud))
        locals_.append(local + rng.normal(0, 1.0, cloud.shape))
        poses.append(T)
    return synth.write_scan_dir(str(root), locals_, poses)


def _features_agree(t_path, j_path):
    t = np.loadtxt(t_path)
    j = np.loadtxt(j_path)
    assert t.shape == j.shape and t.shape[1] == 7
    t_lines = [ln.split()[:3] for ln in open(t_path)]
    j_lines = [ln.split()[:3] for ln in open(j_path)]
    assert t_lines == j_lines
    cos = np.abs((t[:, 3:6] * j[:, 3:6]).sum(1))
    assert (cos >= np.cos(np.deg2rad(1.0))).mean() >= 0.99
    np.testing.assert_allclose(t[:, 6], j[:, 6], rtol=0, atol=1e-4)


def test_scan_to_features_matches_jax(tmp_path):
    idents = _room_dir(tmp_path / "scans")
    for out in ("t", "j"):
        (tmp_path / out).mkdir()
    assert tcv.scan_to_features(str(tmp_path / "scans"), str(tmp_path / "t"), reduce_voxel=-1,
                                device="cpu") == len(idents)
    assert jcv.scan_to_features(str(tmp_path / "scans"), str(tmp_path / "j"), reduce_voxel=-1) == len(idents)
    for i in idents:
        _features_agree(tmp_path / "t" / f"scan{i}.feat", tmp_path / "j" / f"scan{i}.feat")


@pytest.mark.parametrize("voxel", [-1.0, 10.0])
def test_condense_atomize_match_jax(seq, tmp_path, voxel):
    scan_dir, true_mats, _odo = seq
    work = {}
    for side in ("t", "j"):
        d = tmp_path / side
        shutil.copytree(scan_dir, d)
        for fn in os.listdir(d):
            if fn.endswith(".frames"):
                os.remove(d / fn)  # atomize writes them anew
        work[side] = str(d)
    mod = {"t": tcond, "j": jcond}
    kw = {"t": {"device": "cpu"}, "j": {}}
    for side in ("t", "j"):
        n = mod[side].condense(work[side], "uos", split=4, voxel=voxel, use_frames=False, **kw[side])
        assert n == 2
    tc, jc = os.path.join(work["t"], "cond"), os.path.join(work["j"], "cond")
    for k in range(2):
        t = np.loadtxt(os.path.join(tc, f"scan{k:03d}.3d"))
        j = np.loadtxt(os.path.join(jc, f"scan{k:03d}.3d"))
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)
        assert _bytes(os.path.join(tc, f"scan{k:03d}.pose")) == _bytes(os.path.join(jc, f"scan{k:03d}.pose"))
        # a registration result for each metascan: its true anchor pose
        for c in (tc, jc):
            frames_io.write_frames(os.path.join(c, f"scan{k:03d}.frames"), true_mats[4 * k][None], [3])
    assert tcond.atomize(tc, work["t"], "uos", split=4) == 6
    assert jcond.atomize(jc, work["j"], "uos", split=4) == 6
    for k in range(6):
        mt, tt = frames_io.read_frames(frames_io.frames_path(work["t"], f"{k:03d}"))
        mj, tj = frames_io.read_frames(frames_io.frames_path(work["j"], f"{k:03d}"))
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-9)
        assert tt.tolist() == tj.tolist() == [2, 2, 2]


def test_condense_use_frames_places_metascans_at_the_anchor(seq, tmp_path):
    scan_dir, true_mats, _odo = seq
    d = tmp_path / "s"
    shutil.copytree(scan_dir, d)
    assert tcond.condense(str(d), split=3, use_frames=True, device="cpu") == 2
    jd = tmp_path / "j"
    shutil.copytree(scan_dir, jd)
    jcond.condense(str(jd), split=3, use_frames=True)
    for k in range(2):
        assert _bytes(d / "cond" / f"scan{k:03d}.pose") == _bytes(jd / "cond" / f"scan{k:03d}.pose")
        t = np.loadtxt(d / "cond" / f"scan{k:03d}.3d")
        assert len(t) == 3 * 1500
        np.testing.assert_allclose(t, np.loadtxt(jd / "cond" / f"scan{k:03d}.3d"), rtol=0, atol=1e-4)


# ---- torchconvert against tpuconvert ------------------------------------------

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return buf.getvalue()


def _net(path):
    synth.write_net_graph(str(path), 6, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (0, 5), (1, 4)])
    return str(path)


def _matrix_file(path, T):
    np.savetxt(path, T.reshape(1, 16))
    return str(path)


def _frames_only(scan_dir, out):
    os.makedirs(out)
    for fn in os.listdir(scan_dir):
        if fn.endswith(".frames"):
            shutil.copy(os.path.join(scan_dir, fn), out)
    return out


# each case: a function (root, scan_dir, side) -> (argv, [outputs to compare])
def _case(name):
    def frames_dir(root, scan_dir, side):
        return _frames_only(scan_dir, os.path.join(root, side, "frames"))

    T = np.asarray(math3d.euler_to_matrix4(np.array([120.0, -3.0, 40.0]), np.array([0.01, 0.4, -0.02])))
    if name == "frames2pose":
        def build(root, scan_dir, side):
            d = frames_dir(root, scan_dir, side)
            out = os.path.join(root, side, "poses")
            os.makedirs(out)
            return [name, d, "-o", out], [out]
    elif name == "pose2frames":
        def build(root, scan_dir, side):
            out = os.path.join(root, side, "frames_out")
            os.makedirs(out)
            return [name, scan_dir, "-o", out], [out]
    elif name in ("frames2kitti", "frames2tum"):
        def build(root, scan_dir, side):
            out = os.path.join(root, side, "traj.txt")
            os.makedirs(os.path.dirname(out))
            return [name, scan_dir, "-o", out], [out]
    elif name == "kitti2pose":
        def build(root, scan_dir, side):
            kf = os.path.join(root, "traj.kitti")
            if not os.path.exists(kf):
                jcv.frames_to_kitti(scan_dir, kf)
            out = os.path.join(root, side, "kposes")
            return [name, kf, "-o", out], [out]
    elif name == "trajectorylength":
        def build(root, scan_dir, side):
            return [name, scan_dir], []
    elif name == "ate":
        def build(root, scan_dir, side):
            b = os.path.join(root, "odo_frames")
            if not os.path.exists(b):
                os.makedirs(b)
                jcv.pose_to_frames(scan_dir, b)
            return [name, scan_dir, b], []
    elif name == "transformframes":
        def build(root, scan_dir, side):
            d = frames_dir(root, scan_dir, side)
            out = os.path.join(root, side, "tf")
            os.makedirs(out)
            return [name, d, _matrix_file(os.path.join(root, f"{side}T.txt"), T), "-o", out], [out]
    elif name == "multframes":
        def build(root, scan_dir, side):
            out = os.path.join(root, side, "mf")
            return [name, scan_dir, _matrix_file(os.path.join(root, f"{side}T.txt"), T), "-o", out,
                    "--anchor", "2"], [out]
    elif name == "average6dofposes":
        def build(root, scan_dir, side):
            mats, _ = frames_io.read_frames(frames_io.frames_path(scan_dir, "003"))
            p = os.path.join(root, f"{side}mats.txt")
            np.savetxt(p, mats.reshape(-1, 16))
            return [name, p], []
    elif name == "frames2riegl":
        def build(root, scan_dir, side):
            d = frames_dir(root, scan_dir, side)
            out = os.path.join(root, side, "dat")
            os.makedirs(out)
            return [name, d, "-o", out], [out]
    elif name == "riegl2frames":
        def build(root, scan_dir, side):
            src = os.path.join(root, "dat_src")
            if not os.path.exists(src):
                os.makedirs(src)
                jcv.frames_to_riegl(scan_dir, src)
            out = os.path.join(root, side, "rf")
            os.makedirs(out)
            return [name, src, "-o", out], [out]
    elif name == "scandiff":
        def build(root, scan_dir, side):
            out = os.path.join(root, f"{side}diff.3d")
            return [name, scan_dir, "-d", str(MAX_DIST), "-a", "0", "-b", "1", "-o", out], [out]
    elif name == "scandiff2d":
        def build(root, scan_dir, side):
            out = os.path.join(root, f"{side}diff.png")
            return [name, scan_dir, "-d", str(MAX_DIST), "-o", out], [out]
    elif name == "condense":
        def build(root, scan_dir, side):
            out = os.path.join(root, side, "cond")
            return [name, scan_dir, "--split", "3", "-o", out, "--use-frames"], [out]
    elif name == "atomize":
        def build(root, scan_dir, side):
            orig = os.path.join(root, side, "orig")
            shutil.copytree(scan_dir, orig)
            cond = os.path.join(root, side, "cond")
            jcond.condense(orig, split=3, out_dir=cond)
            for k in range(2):
                frames_io.write_frames(os.path.join(cond, f"scan{k:03d}.frames"), T[None], [3])
            return [name, cond, orig, "--split", "3"], [orig]
    elif name == "frames2graph":
        def build(root, scan_dir, side):
            out = os.path.join(root, f"{side}graph.txt")
            return [name, scan_dir, "-s", "1", "-e", "4", "-o", out], [out]
    elif name == "convergence":
        def build(root, scan_dir, side):
            out = os.path.join(root, f"{side}conv.dat")
            return [name, scan_dir, "-s", "2", "-z", "local", "-o", out], [out]
    elif name == "graphbalancer":
        def build(root, scan_dir, side):
            net = _net(os.path.join(root, f"{side}g.net"))
            out = os.path.join(root, f"{side}w.txt")
            return [name, net, "-s", "0", "-e", "5", "-o", out], [out]
    elif name == "sicp":
        def build(root, scan_dir, side):
            rng = np.random.default_rng(15)
            g = rng.uniform(-500, 500, (400, 3))
            gl = os.path.join(root, f"{side}g.txt")
            ll = os.path.join(root, f"{side}l.txt")
            np.savetxt(gl, g)
            np.savetxt(ll, np.asarray(math3d.transform3(np.linalg.inv(T), g)) + rng.normal(0, 0.5, g.shape))
            return [name, "-g", gl, "-l", ll, "-n", "300"], []
    elif name == "scan2features":
        def build(root, scan_dir, side):
            out = os.path.join(root, side, "feat")
            os.makedirs(out)
            return [name, scan_dir, "-r", "-1", "-K", "12", "-o", out], [out]
    else:
        raise KeyError(name)
    return build


SUBCOMMANDS = [
    "frames2pose", "pose2frames", "frames2kitti", "kitti2pose", "frames2tum",
    "trajectorylength", "ate", "transformframes", "multframes", "average6dofposes",
    "frames2riegl", "riegl2frames", "scandiff", "condense", "atomize", "frames2graph",
    "convergence", "graphbalancer", "sicp", "scandiff2d", "scan2features",
]


def _compare_outputs(name, t_out, j_out):
    if os.path.isdir(t_out):
        files = sorted(os.listdir(j_out))
        assert sorted(os.listdir(t_out)) == files and files
        pairs = [(os.path.join(t_out, f), os.path.join(j_out, f)) for f in files
                 if os.path.isfile(os.path.join(j_out, f))]
    else:
        pairs = [(t_out, j_out)]
    for t, j in pairs:
        if name == "condense" and t.endswith(".3d"):
            np.testing.assert_allclose(np.loadtxt(t), np.loadtxt(j), rtol=0, atol=1e-4)
        elif name == "scan2features" and t.endswith(".feat"):
            _features_agree(t, j)
        else:
            assert _bytes(t) == _bytes(j), os.path.basename(t)


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_torchconvert_matches_tpuconvert(seq, tmp_path, name):
    assert set(SUBCOMMANDS) == set(tconvert.build_parser()._subparsers._group_actions[0].choices)
    scan_dir, *_ = seq
    if name == "scan2features":
        _room_dir(tmp_path / "room", n_scans=1, n=1200)
        scan_dir = str(tmp_path / "room")
    build = _case(name)
    argv_t, outs_t = build(str(tmp_path), scan_dir, "t")
    argv_j, outs_j = build(str(tmp_path), scan_dir, "j")
    text_t = _run(tconvert.main, argv_t + ["--device", "cpu"])
    text_j = _run(jconvert.main, argv_j)
    for t_out, j_out in zip(outs_t, outs_j):
        _compare_outputs(name, t_out, j_out)
    if name == "sicp":
        np.testing.assert_allclose(np.array(text_t.split(), float).reshape(4, 4),
                                   np.array(text_j.split(), float).reshape(4, 4), rtol=0, atol=1e-4)
    elif name == "ate":
        assert json.loads(text_t) == json.loads(text_j)
    else:
        assert text_t.replace(str(tmp_path / "t"), "<out>") == \
            text_j.replace(str(tmp_path / "j"), "<out>")


# ---- torchexport against tpuexport -------------------------------------------

@pytest.mark.parametrize("flags", [["-r", "-1"], ["-r", "20", "-O", "0"], ["--use-pose", "-m", "400"],
                                   ["-r", "-1", "--per-scan", "-s", "1", "-e", "3"]])
def test_torchexport_matches_tpuexport(seq, tmp_path, flags):
    scan_dir, *_ = seq
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    out_t, out_j = str(tmp_path / "t" / "points.pts"), str(tmp_path / "j" / "points.pts")
    text_t = _run(texport.main, [scan_dir, *flags, "-o", out_t, "--device", "cpu"])
    text_j = _run(jexport.main, [scan_dir, *flags, "-o", out_j])
    assert text_t.replace(out_t, "") == text_j.replace(out_j, "")
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == files
    for f in files:
        t, j = str(tmp_path / "t" / f), str(tmp_path / "j" / f)
        if "-O" in flags:
            a, b = np.loadtxt(t), np.loadtxt(j)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
        else:
            assert _bytes(t) == _bytes(j), f
