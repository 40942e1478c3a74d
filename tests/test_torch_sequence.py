"""The slice as a whole: sequential registration in the JAX package and
in the port, on the same scans.

- Library: both ``SequenceRegistration``s on ten small scans; the
  JAX-reduced points are carried into the port through
  ``interop.scans_from_numpy`` so both register the same points.
- CLI: ``tpuslam`` and ``torchslam`` on one uos directory with ``-O 0``
  (deterministic center reduction, equal in both packages).

Bounds (tests/test_graph_pipeline_device.py:103-109): poses within
0.5 cm translation and 1e-3 on rotation entries, iterations ±1 per
match.  Metascan mode is held to ±3 iterations instead: its models grow
to the whole sequence, so the f32 pair-stats noise (summation order
differs between XLA and torch) keeps the late pose increments near the
1e-2 cm fixpoint threshold for longer and the stop moves, while the
poses still agree to ~0.006 cm.  Measured on the ten scans below (CPU):
window 1, JAX 6 6 7 8 10 8 5 7 7 and the port the same; metascan, JAX
6 6 7 7 8 14 6 10 11 and the port 6 5 7 7 8 14 6 7 10."""

import os

import numpy as np
import pytest

from tpu3dtk.core.scan import TPUScan
from tpu3dtk.io import frames as jframes
from tpu3dtk.models.icp import IcpParams as JIcpParams
from tpu3dtk.models.sequence import SequenceRegistration as JSeq
from tpu3dtk_torch import interop
from tpu3dtk_torch.io import frames as tframes
from tpu3dtk_torch.models.sequence import SequenceRegistration as TSeq
from tpu3dtk_torch.ops import nn_cuda
from tpu3dtk_torch.synth import synth_loop, write_scan_dir

PARAMS = dict(max_dist_match2=2500.0, max_iterations=30, epsilon=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_numpy(s):
    return {
        "identifier": s.identifier, "xyz": s.xyz,
        "reduced_local": s.reduced_local(), "transMatOrg": s.transMatOrg,
        "transMat": s.transMat, "dalignxf": s.dalignxf, "frames": s.frames,
        "reduction_voxel": s.reduction_voxel,
        "reduction_nrpts": s.reduction_nrpts,
    }


def _assert_poses_close(a, b):
    np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=0.5)
    np.testing.assert_allclose(a[:3, :3], b[:3, :3], atol=1e-3)


@pytest.mark.parametrize("metascan", [False, True])
def test_sequence_registration_matches_jax(metascan):
    locs, _true, odo = synth_loop(n_scans=10, n_pts=1500, seed=5)
    jscans = []
    for k, (loc, To) in enumerate(zip(locs, odo)):
        s = TPUScan.from_points(loc, f"{k:03d}", To)
        s.set_reduction(25.0, 1)
        s.reduced_local()
        jscans.append(s)
    tscans, tparams = interop.scans_from_numpy(
        [_as_numpy(s) for s in jscans], PARAMS
    )
    for j, t in zip(jscans, tscans):
        np.testing.assert_array_equal(t.reduced_local(), j.reduced_local())

    launches = nn_cuda.nn_brute_kernel.launches
    jres = JSeq(params=JIcpParams(**PARAMS), metascan=metascan, mesh=None).run(jscans)
    tres = TSeq(params=tparams, metascan=metascan, device="cpu").run(tscans)

    assert [r["identifier"] for r in tres] == [r["identifier"] for r in jres]
    slack = 3 if metascan else 1  # see the module docstring
    for jr, tr in zip(jres, tres):
        assert abs(tr["iterations"] - jr["iterations"]) <= slack
        assert tr["error"] == pytest.approx(jr["error"], abs=0.05)
    for j, t in zip(jscans, tscans):
        _assert_poses_close(t.transMat, j.transMat)
        assert [f[1] for f in t.frames] == [f[1] for f in j.frames]
    assert nn_cuda.nn_brute_kernel.launches == launches  # CPU: the plain path


def test_run_single_matches_run():
    """The per-match entry (what the graph pipeline will call) gives
    the device loop's poses."""
    locs, _true, odo = synth_loop(n_scans=4, n_pts=1200, seed=9)
    mk = lambda: interop.scans_from_numpy(  # noqa: E731
        [{"identifier": f"{k:03d}", "xyz": loc, "transMatOrg": To}
         for k, (loc, To) in enumerate(zip(locs, odo))], PARAMS,
    )
    a, params = mk()
    b, _ = mk()
    for s in a + b:
        s.device = "cpu"
        s.set_reduction(25.0, 0)
    TSeq(params=params, metascan=True, device="cpu").run(a)
    reg = TSeq(params=params, metascan=True, device="cpu")
    infos = [reg.run_single(b, i) for i in range(1, len(b))]
    assert all(i["iterations"] >= 1 for i in infos)
    for x, y in zip(a, b):
        _assert_poses_close(x.transMat, y.transMat)
        assert len(x.frames) == len(y.frames)


@pytest.mark.parametrize("n_meta", [1, 2, 3])
def test_max_num_metascans_matches_jax_run_single(n_meta):
    """A metascan of the last n scans: match i sees scans [max(0, i - n),
    i).  The port's ``run`` (its device loop) and ``run_single`` against
    the JAX package's per-match loop (its device loop starts every window
    at scan 0, ROADMAP queue 3), at the bounds above."""
    locs, _true, odo = synth_loop(n_scans=8, n_pts=1500, seed=5)
    jscans = []
    for k, (loc, To) in enumerate(zip(locs, odo)):
        s = TPUScan.from_points(loc, f"{k:03d}", To)
        s.set_reduction(25.0, 1)
        s.reduced_local()
        jscans.append(s)
    runs = [
        interop.scans_from_numpy([_as_numpy(s) for s in jscans], PARAMS)
        for _ in range(2)
    ]
    jreg = JSeq(params=JIcpParams(**PARAMS), metascan=True,
                max_num_metascans=n_meta, mesh=None)
    jres = [jreg.run_single(jscans, i) for i in range(1, len(jscans))]
    for single, (tscans, tparams) in zip((False, True), runs):
        treg = TSeq(params=tparams, metascan=True, max_num_metascans=n_meta,
                    device="cpu")
        if single:
            tres = [treg.run_single(tscans, i) for i in range(1, len(tscans))]
        else:
            tres = treg.run(tscans)
        for jr, tr in zip(jres, tres):
            assert abs(tr["iterations"] - jr["iterations"]) <= 3
        for j, t in zip(jscans, tscans):
            _assert_poses_close(t.transMat, j.transMat)
            assert [f[1] for f in t.frames] == [f[1] for f in j.frames]


@pytest.fixture(scope="module")
def uos_dir(tmp_path_factory):
    locs, _true, odo = synth_loop(n_scans=4, n_pts=1500, seed=3)
    d = tmp_path_factory.mktemp("uos")
    write_scan_dir(str(d), locs, odo)
    return str(d)


def test_cli_matches_jax_cli(uos_dir, tmp_path):
    from tpu3dtk.cli import slam6d as jcli
    from tpu3dtk_torch.cli import slam6d as tcli

    flags = ["-f", "uos", "-r", "25", "-O", "0", "-d", "50", "-i", "30",
             "--epsICP", "1e-6", "-q"]
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    jout.mkdir()
    tout.mkdir()
    assert jcli.main([uos_dir, *flags, "--frames-out", str(jout)]) == 0
    assert tcli.main(
        [uos_dir, *flags, "--frames-out", str(tout), "--device", "cpu"]
    ) == 0
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout)) and len(names) == 4
    for n in names:
        jm, jt = jframes.read_frames(str(jout / n))
        tm, tt = tframes.read_frames(str(tout / n))
        np.testing.assert_array_equal(tt, jt)
        _assert_poses_close(tm[-1], jm[-1])


def test_cli_scan_range_export_and_continue(uos_dir, tmp_path):
    """--scans, --exportAllPoints and --continue, against tpuslam."""
    import shutil

    from tpu3dtk.cli import slam6d as jcli
    from tpu3dtk_torch.cli import slam6d as tcli

    flags = ["-f", "uos", "-r", "25", "-O", "0", "-d", "50", "-i", "30",
             "--epsICP", "1e-6", "--prefetch", "0", "-q", "--scans", "1:3",
             "--exportAllPoints"]
    outs = {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        out = tmp_path / name
        out.mkdir()
        assert cli.main([uos_dir, *flags, "--frames-out", str(out), *extra]) == 0
        outs[name] = out
    names = sorted(os.listdir(outs["torch"]))
    assert names == sorted(os.listdir(outs["jax"]))
    assert names == ["points.pts", "scan001.frames", "scan002.frames", "scan003.frames"]
    jp = np.loadtxt(outs["jax"] / "points.pts")
    tp = np.loadtxt(outs["torch"] / "points.pts")
    assert tp.shape == jp.shape
    np.testing.assert_allclose(tp, jp, atol=0.5)

    # --continue: start from the written .frames, which are a fixpoint
    d = tmp_path / "scans"
    shutil.copytree(uos_dir, d)
    for n in names[1:]:
        shutil.copy(outs["torch"] / n, d / n)
    again = tmp_path / "again"
    again.mkdir()
    assert tcli.main(
        [str(d), *flags, "--frames-out", str(again), "--device", "cpu",
         "--continue"]
    ) == 0
    for n in names[1:]:
        first = tframes.final_pose(str(outs["torch"] / n))
        _assert_poses_close(tframes.final_pose(str(again / n)), first)


def test_frames_text_identical_for_equal_matrices(tmp_path):
    rng = np.random.default_rng(0)
    mats = rng.normal(size=(3, 4, 4))
    types = [1, 2, 0]
    jframes.write_frames(str(tmp_path / "j.frames"), mats, types)
    tframes.write_frames(str(tmp_path / "t.frames"), mats, types)
    assert (tmp_path / "j.frames").read_text() == (tmp_path / "t.frames").read_text()


@pytest.mark.parametrize(
    "flag,item",
    [
        (["-L", "6"], "0..4"), (["-G", "-1"], "0..4"), (["-L", "-2"], "0..4"),
        (["-G", "7"], "0..4"), (["--distributed", "-a", "11"], "1..10"),
        (["-a", "0"], "1..10"), (["-a", "11"], "1..10"),
        (["-a", "-3"], "1..10"),
    ],
)
def test_cli_refuses_unported_flags(flag, item, capsys, tmp_path):
    """Every flag of tpuslam is ported (--distributed:
    tests/test_torch_distributed.py); values slam6D does not define stop
    the run, with --distributed too."""
    from tpu3dtk_torch.cli import slam6d as tcli

    assert not hasattr(tcli, "_NOT_PORTED")

    with pytest.raises(SystemExit) as e:
        tcli.main([str(tmp_path), *flag])
    assert e.value.code == 2
    err = capsys.readouterr().err
    # an unported path names its ROADMAP item; a value slam6D does not
    # define names the range it does
    assert ("not ported" in err or "not a slam6D choice" in err) and item in err


@pytest.fixture(scope="module")
def loop8_dir(tmp_path_factory):
    """The directory of ROADMAP queue 3's F1: its -O 0 voxel centres lie
    on a lattice, and ICP converges to exactly aligned pairs there."""
    locs, _true, odo = synth_loop(n_scans=8, n_pts=1500, seed=3)
    d = tmp_path_factory.mktemp("loop8")
    write_scan_dir(str(d), locs, odo)
    return str(d)


# -a 4 (dual quaternions) leaves the truth chaotically in both packages
# (ROADMAP queue 3) and is held on shared statistics instead
# (tests/test_torch_minimizers.py); -a 10 (napx) rests on normals that
# differ on lattice clouds (tests/test_torch_normals.py)
@pytest.mark.parametrize("algo", [2, 3, 5, 6, 7, 8, 9])
def test_cli_minimizers_match_jax_cli(algo, loop8_dir, tmp_path):
    """torchslam -a N against tpuslam -a N on F1's directory: the same
    frames tags, final poses within 0.5 cm / 1e-3.  -a 5 is F1: the
    port's helix used to turn a pose into NaN there and crash."""
    from tpu3dtk.cli import slam6d as jcli
    from tpu3dtk_torch.cli import slam6d as tcli

    flags = ["-f", "uos", "-r", "25", "-O", "0", "-d", "50", "-i", "30",
             "--epsICP", "1e-6", "--prefetch", "0", "-q", "-a", str(algo)]
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    jout.mkdir()
    tout.mkdir()
    assert jcli.main([loop8_dir, *flags, "--frames-out", str(jout)]) == 0
    assert tcli.main(
        [loop8_dir, *flags, "--frames-out", str(tout), "--device", "cpu"]
    ) == 0
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout)) and len(names) == 8
    for n in names:
        jm, jt = jframes.read_frames(str(jout / n))
        tm, tt = tframes.read_frames(str(tout / n))
        np.testing.assert_array_equal(tt, jt)
        assert np.isfinite(tm).all()
        _assert_poses_close(tm[-1], jm[-1])
