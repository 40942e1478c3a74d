"""The slice as a whole: the port's ``GraphPipeline`` (sequential ICP,
loop detection, ELCH slerp closure, cached 1-iteration LUM per closure,
final LUM relax) against the JAX package's on the same numpy inputs, the
circuit of tests/test_graph_pipeline_device.py cut to 16 scans of 900
points.

Bounds:
- closures: the same (first, last, upto) in the same order;
- final poses within 0.5 cm / 1e-3 of the JAX pipeline (its own bound
  between its two sequential loops), frame counts within 3 (a LUM
  convergence test may flip by an iteration: f64 solve here, f32 there);
- cached against uncached closures within 2.0 cm / 5e-3, the JAX
  package's own bound and the loosest one allowed;
- ``build_proximity_graph`` / ``build_clpairs_graph``: equal link sets;
- ``torchslam -L 4 -G 1 --device cpu`` against ``tpuslam -L 4 -G 1``:
  equal AlgoType tags up to 3 LUM frames, poses within 0.5 cm / 1e-3;
  ``-L 5`` and ``-G 5`` exit 2;
- the variants (``slam_algo`` 2..4 with ``elch_algo`` 1..3): the same
  closures, poses within 0.5 cm / 1e-3 of the JAX pipeline, equal tags.
"""

import os

import numpy as np
import pytest
import torch

from tpu3dtk.core import math3d as jmath
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.models import graphslam as jgs
from tpu3dtk.models.graph_pipeline import GraphPipeline as JGraphPipeline
from tpu3dtk.models.icp import IcpParams as JIcpParams
from tpu3dtk_torch import interop, synth
from tpu3dtk_torch.io.frames import AlgoType
from tpu3dtk_torch.models import graphslam as tgs
from tpu3dtk_torch.models.graph_pipeline import GraphPipeline


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The clouds here are small: one intra-op thread is faster than
    eight, and does not fight the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def circuit_scans(n_scans=16, n_pts=900, seed=3):
    """Closed circuit through a hall, odometry with drift
    (tests/test_graph_pipeline_device.py:17-52), as JAX-side scans."""
    rng = np.random.default_rng(seed)
    size = 2000.0
    walls = []
    for axis in range(3):
        for side in (0.0, size):
            p = rng.uniform(0, size, (1800, 3))
            p[:, axis] = side
            walls.append(p)
    env = np.concatenate(walls)
    scans = []
    drift = np.zeros(3)
    for k in range(n_scans):
        ang = 2 * np.pi * k / n_scans
        center = np.array(
            [size / 2 + 600 * np.cos(ang), size / 2, size / 2 + 600 * np.sin(ang)]
        )
        T = np.asarray(jmath.euler_to_matrix4(center, np.array([0.0, -ang, 0.0]), xp=np))
        d2 = ((env - center) ** 2).sum(1)
        vis = env[d2 < 900.0**2]
        vis = vis[rng.permutation(len(vis))[:n_pts]]
        Ti = np.linalg.inv(T)
        local = vis @ Ti[:3, :3].T + Ti[:3, 3]
        local += rng.normal(0, 1.0, local.shape)
        drift += rng.normal(0, 3.0, 3)
        To = T.copy()
        To[:3, 3] += drift
        s = TPUScan.from_points(local.astype(np.float32), f"{k:03d}", To)
        s.set_reduction(20.0, 1)
        s.reduced_local()
        scans.append(s)
    return scans


def carry(jscans):
    """The JAX-side scans' state into the port."""
    return interop.scans_from_numpy(
        [
            {"identifier": s.identifier, "xyz": s.xyz,
             "reduced_local": s.reduced_local(), "transMatOrg": s.transMatOrg,
             "transMat": s.transMat, "reduction_voxel": s.reduction_voxel,
             "reduction_nrpts": s.reduction_nrpts}
            for s in jscans
        ]
    )[0]


def jax_pipe(**kw):
    p = JGraphPipeline(
        icp_params=JIcpParams(max_dist_match2=2500.0, max_iterations=30, epsilon=1e-6),
        lum_max_dist2=2500.0, lum_iterations=5, lum_epsilon=0.1, elch=True,
        cldist=500.0, loopsize=6, seq_mesh=None, lum_mesh=None,
        device_segments=False, **kw,
    )
    p.closures = []
    inner = p._close_and_relax

    def recording(scans, first, last, edges, upto):
        p.closures.append((first, last, upto))
        return inner(scans, first, last, edges, upto)

    p._close_and_relax = recording
    return p


def torch_pipe(jp):
    fields = {k: v for k, v in vars(jp).items() if k not in ("closures", "_close_and_relax")}
    return interop.graph_pipeline_from(fields, device="cpu")


def assert_poses_close(tscans, jscans, atol_t, atol_r):
    for t, j in zip(tscans, jscans):
        np.testing.assert_allclose(t.transMat[:3, 3], j.transMat[:3, 3], atol=atol_t)
        np.testing.assert_allclose(t.transMat[:3, :3], j.transMat[:3, :3], atol=atol_r)


@pytest.fixture(scope="module")
def circuit():
    return circuit_scans()


@pytest.fixture(scope="module")
def cached_runs(circuit):
    """Both packages through the cached 1-iteration closure relax."""
    jscans = [_copy(s) for s in circuit]
    tscans = carry(circuit)
    jp = jax_pipe(closure_lum_iterations=1)
    tp = torch_pipe(jp)
    jres = jp.run(jscans)
    tres = tp.run(tscans)
    return jp, tp, jscans, tscans, jres, tres


def _copy(s):
    c = TPUScan.from_points(np.array(s.reduced_local()), s.identifier, s.transMatOrg.copy())
    c._reduced_local = s.reduced_local()
    return c


def test_pipeline_matches_jax(cached_runs):
    jp, tp, jscans, tscans, jres, tres = cached_runs
    assert tp.closure_lum_iterations == 1 and tp.elch and tp.loopsize == 6
    assert len(jp.closures) >= 1
    assert tp.closures == jp.closures
    assert [r["identifier"] for r in tres] == [r["identifier"] for r in jres]
    assert max(abs(a["iterations"] - b["iterations"]) for a, b in zip(tres, jres)) <= 3
    assert_poses_close(tscans, jscans, 0.5, 1e-3)
    for t, j in zip(tscans, jscans):
        assert abs(len(t.frames) - len(j.frames)) <= 3
        tags_t, tags_j = [f[1] for f in t.frames], [f[1] for f in j.frames]
        n = tags_j.index(int(AlgoType.LUM))
        assert tags_t[:n] == tags_j[:n]  # ICP and ELCH records, then LUM
        assert tags_t.count(int(AlgoType.ELCH)) == tags_j.count(int(AlgoType.ELCH)) == len(jp.closures)
        assert tags_t[-1] == int(AlgoType.LUM)


def test_cached_path_ran_and_counts_match(cached_runs):
    jp, tp, *_ = cached_runs
    for name in ("_lum_corr_cache", "_elch_corr_cache"):
        tc, jc = getattr(tp, name), getattr(jp, name)
        assert tc.n_refresh > 0
        assert (tc.n_refresh, tc.n_reuse) == (jc.n_refresh, jc.n_reuse)
        assert tc.slots == jc.slots
        assert tc.resident_bytes() == tc.L * tc.N * 5


def test_cached_matches_uncached(circuit, cached_runs):
    _jp, tp, _j, cached, *_ = cached_runs
    uncached = carry(circuit)
    p = torch_pipe(jax_pipe(closure_lum_iterations=1))
    orig = p._prepare_statics

    def no_cache(scans_):
        seq = orig(scans_)
        p._lum_corr_cache = None
        p._elch_corr_cache = None
        return seq

    p._prepare_statics = no_cache
    p.run(uncached)
    assert p.closures == tp.closures
    assert_poses_close(cached, uncached, 2.0, 5e-3)


def test_full_budget_closure_relax_matches_jax(circuit):
    """closure_lum_iterations=None: every closure relaxes with the -I
    budget through ``lum_run`` (the CLI's setting)."""
    jscans = [_copy(s) for s in circuit]
    tscans = carry(circuit)
    jp = jax_pipe()
    tp = torch_pipe(jp)
    jp.run(jscans)
    tp.run(tscans)
    assert tp.closures == jp.closures
    assert tp._lum_corr_cache.n_refresh == 0  # the multi-iteration relax never caches
    assert_poses_close(tscans, jscans, 0.5, 1e-3)
    for t, j in zip(tscans, jscans):
        assert abs(len(t.frames) - len(j.frames)) <= 3


def test_runs_without_closure():
    jscans = circuit_scans(n_scans=8)
    tscans = carry(jscans)
    jp = jax_pipe()
    jp.elch = False
    jp.cldist = 1.0  # nothing ever within closure distance
    tp = torch_pipe(jp)
    jres, tres = jp.run(jscans), tp.run(tscans)
    assert len(tres) == len(jres) == 7 and tp.closures == jp.closures == []
    assert_poses_close(tscans, jscans, 0.5, 1e-3)
    assert [f[1] for f in tscans[3].frames].count(int(AlgoType.LUM)) >= 1


def test_unported_variants_are_refused():
    """Every -L 1..4 / -G 1..4 is ported; what lies outside raises."""
    for kw, item in ((dict(elch=True, elch_algo=5), "-L 5"), (dict(slam_algo=5), "-G 5")):
        with pytest.raises(ValueError, match=item):
            GraphPipeline(device="cpu", **kw).run([])
    for algo in (1, 2, 3, 4):
        assert GraphPipeline(device="cpu", elch=True, elch_algo=algo, slam_algo=algo).run([]) == []


@pytest.mark.parametrize("slam_algo,elch_algo", [(2, 2), (3, 1), (4, 3)])
def test_variant_pipelines_match_jax(circuit, slam_algo, elch_algo):
    """The JAX pipeline's _do_graph_slam and ELCH_VARIANTS dispatch, with
    the cached 1-iteration closure relax (which the variants ignore)."""
    jscans = [_copy(s) for s in circuit]
    tscans = carry(circuit)
    jp = jax_pipe(closure_lum_iterations=1, slam_algo=slam_algo, elch_algo=elch_algo)
    tp = torch_pipe(jp)
    assert (tp.slam_algo, tp.elch_algo) == (slam_algo, elch_algo)
    jp.run(jscans)
    tp.run(tscans)
    assert len(jp.closures) >= 1 and tp.closures == jp.closures
    assert_poses_close(tscans, jscans, 0.5, 1e-3)
    for t, j in zip(tscans, jscans):
        assert [f[1] for f in t.frames] == [f[1] for f in j.frames]
    assert tp._elch_corr_cache.n_refresh == jp._elch_corr_cache.n_refresh
    assert tp._lum_corr_cache.n_refresh == 0  # the variants never read it


def test_graph_constructors_match_jax(circuit):
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 1500, (40, 3))
    for cld2, loopsize in ((300.0**2, 5), (600.0**2, 1), (1.0, 3)):
        np.testing.assert_array_equal(
            tgs.build_proximity_graph(pos, cld2, loopsize),
            jgs.build_proximity_graph(pos, cld2, loopsize),
        )
    assert tgs.build_proximity_graph(pos[:1], 1.0, 1).shape == (0, 2)
    jscans = circuit[:8]
    tscans = carry(jscans)
    for min_pairs in (0, 150, 10**6):
        jl = jgs.build_clpairs_graph(jscans, 2500.0, min_pairs)
        tl = tgs.build_clpairs_graph(tscans, 2500.0, min_pairs, device="cpu")
        np.testing.assert_array_equal(tl, jl)
    assert len(tgs.build_clpairs_graph(tscans, 2500.0, 150, device="cpu")) > 0


FLAGS = ["-f", "uos", "-r", "25", "-O", "0", "-d", "50", "-i", "30", "--epsICP", "1e-6",
         "-q", "-I", "3", "-D", "50", "--epsSLAM", "0.1", "--cldist", "500",
         "--loopsize", "8"]


def _cli_dir(tmp_path):
    # 18 scans: no pose at a quarter turn, where the Euler LUM is
    # ill-conditioned (gimbal lock) and even the JAX package's own device
    # and host relaxations differ by 1 cm
    locs, _true, odo = synth.synth_loop(n_scans=18, n_pts=1200, seed=3)
    d = tmp_path / "scans"
    synth.write_scan_dir(str(d), locs, odo)
    return d


@pytest.mark.parametrize("mode", [["-L", "4", "-G", "1"], ["-C", "200"]])
def test_cli_matches_jax_cli(tmp_path, mode):
    from tpu3dtk.cli import slam6d as jcli
    from tpu3dtk.io import frames as jframes
    from tpu3dtk_torch.cli import slam6d as tcli
    from tpu3dtk_torch.io import frames as tframes

    d = _cli_dir(tmp_path)
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    jout.mkdir()
    tout.mkdir()
    assert jcli.main([str(d), *FLAGS, *mode, "--frames-out", str(jout)]) == 0
    assert tcli.main([str(d), *FLAGS, *mode, "--frames-out", str(tout), "--device", "cpu"]) == 0
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout)) and len(names) == 18
    kinds = set()
    for n in names:
        jm, jt = jframes.read_frames(str(jout / n))
        tm, tt = tframes.read_frames(str(tout / n))
        assert abs(len(tt) - len(jt)) <= 3
        kinds |= set(int(v) for v in tt)
        np.testing.assert_allclose(tm[-1][:3, 3], jm[-1][:3, 3], atol=0.5)
        np.testing.assert_allclose(tm[-1][:3, :3], jm[-1][:3, :3], atol=1e-3)
    assert int(AlgoType.LUM) in kinds and int(AlgoType.ICP) in kinds
    if "-L" in mode:
        assert int(AlgoType.ELCH) in kinds


@pytest.mark.parametrize("flag", [["-L", "5"], ["-G", "5"]])
def test_cli_refuses_unported_variants(flag, capsys, tmp_path):
    """-L and -G take 0..4; anything else exits 2 before a scan is read."""
    from tpu3dtk_torch.cli import slam6d as tcli

    with pytest.raises(SystemExit) as e:
        tcli.main([str(tmp_path), *flag])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag[0]}" in err and "0..4" in err


@pytest.mark.slow
def test_ate_loop60():
    """The port's version of tests/test_ate.py::test_ate_loop60: the
    60-scan synthetic loop through -L 4 -G 1, ATE below 10 cm and below
    odometry's."""
    from tpu3dtk_torch.core.scan import Scan
    from tpu3dtk_torch.models.icp import IcpParams

    locs, true_mats, odo = synth.synth_loop()
    scans = []
    for k, (loc, To) in enumerate(zip(locs, odo)):
        s = Scan.from_points(loc, f"{k:03d}", To)
        s.device = "cpu"
        s.set_reduction(10.0, 1)
        scans.append(s)
    GraphPipeline(
        icp_params=IcpParams(max_dist_match2=2500.0, max_iterations=50, epsilon=1e-6),
        lum_max_dist2=2500.0, lum_iterations=10, lum_epsilon=0.1, elch=True,
        cldist=300.0, loopsize=10, device="cpu",
    ).run(scans)

    def ate(mats):
        d = np.stack([m[:3, 3] for m in mats]) - np.stack([m[:3, 3] for m in true_mats])
        return float(np.sqrt((d**2).sum(1).mean()))

    err = ate([s.transMat for s in scans])
    assert err < 10.0 and err < ate(odo)
