"""The LUM graph relaxation of the port (host path,
``tpu3dtk_torch.models.graphslam``) against the JAX package's, on the
same numpy inputs.

Bounds:
- ``lum_pair_stats``: f32 sums in another order than XLA's: C, CD within
  1e-4 relative (of the largest entry), m equal.
- ``assemble_GB``, ``lum_pose_corrections``, ``read_net_graph``: f64 host
  numpy, the same formulas: 1e-12; ``_solve_GX_B`` above its dense
  limit (block-CG): 1e-8 relative.
- ``link_covariances_chained``: the port ranks exactly, the JAX chain
  with its split ranking (a handful of near-equidistant pairs may swap,
  tests/test_graphslam.py:247-254): pair counts equal, C and CD within
  5% by norm of JAX's; against the port's own brute engine 1e-5.
- ``do_graph_slam`` against JAX's ``_do_graph_slam_host`` (like with
  like: the JAX package's default on a CPU is its on-device f32 Jacobi
  relaxation): poses within 0.05 cm and 1e-5 on rotation entries — five
  iterations of an f64 solve on f32 covariance sums.
- ``torchslam -n`` against ``tpuslam -n`` (which does take the on-device
  f32 relaxation): equal AlgoType tags, poses within 0.5 cm / 1e-3 (the
  bound of tests/test_torch_sequence.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_room_cloud
from tpu3dtk.core import math3d as jmath
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.io import frames as jframes
from tpu3dtk.models import graphslam as jgs
from tpu3dtk.ops import nn_pallas as npl
from tpu3dtk_torch import interop, synth
from tpu3dtk_torch.io import frames as tframes
from tpu3dtk_torch.io.frames import AlgoType
from tpu3dtk_torch.models import graphslam as tgs
from tpu3dtk_torch.utils.metrics import metrics


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run has six test processes, and
    eight spinning threads each slow every process on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def test_lum_pair_stats_matches_jax(rng):
    a = rng.uniform(0, 800, (3000, 3)).astype(np.float32)
    b = (a + rng.normal(0, 2, a.shape) + [1.0, -0.5, 0.3]).astype(np.float32)
    found = rng.uniform(size=len(a)) > 0.2
    jC, jCD, jm = jgs.lum_pair_stats(jnp.asarray(a), jnp.asarray(b), jnp.asarray(found))
    tC, tCD, tm = tgs.lum_pair_stats(_t(a), _t(b), _t(found))
    assert float(tm) == float(jm) == found.sum()
    jC, jCD = np.asarray(jC), np.asarray(jCD)
    np.testing.assert_allclose(tC.numpy(), jC, atol=1e-4 * np.abs(jC).max())
    np.testing.assert_allclose(tCD.numpy(), jCD, atol=1e-4 * np.abs(jCD).max())
    # degenerate inputs: too few pairs, identical clouds -> zeros
    few = np.zeros(len(a), bool)
    few[:2] = True
    for aa, bb, ff in ((a, b, few), (a, a, found)):
        tC, tCD, _ = tgs.lum_pair_stats(_t(aa), _t(bb), _t(ff))
        jC, jCD, _ = jgs.lum_pair_stats(jnp.asarray(aa), jnp.asarray(bb), jnp.asarray(ff))
        assert not tC.numpy().any() and not np.asarray(jC).any()
        assert not tCD.numpy().any() and not np.asarray(jCD).any()


def test_assemble_and_corrections_match_jax(rng):
    links = np.array([[0, 1], [1, 2], [2, 3], [0, 3], [3, 1]], np.int32)
    A = rng.normal(size=(len(links), 6, 6))
    C = A @ A.transpose(0, 2, 1)
    CD = rng.normal(size=(len(links), 6))
    jG, jB = jgs.assemble_GB(links, C, CD, 4)
    tG, tB = tgs.assemble_GB(links, C, CD, 4)
    np.testing.assert_allclose(tG, jG, atol=1e-12)
    np.testing.assert_allclose(tB, jB, atol=1e-12)
    np.testing.assert_allclose(
        tgs._solve_GX_B(4, links, C, CD, 65), jgs._solve_GX_B(4, links, C, CD, 65),
        atol=1e-12,
    )
    # above dense_max the host path takes block-CG, as the JAX one does
    np.testing.assert_allclose(
        tgs._solve_GX_B(70, links, C, CD, 65), jgs._solve_GX_B(70, links, C, CD, 65),
        rtol=0, atol=1e-8 * np.abs(jgs._solve_GX_B(70, links, C, CD, 65)).max(),
    )
    pos = rng.uniform(-500, 500, (3, 3))
    theta = rng.uniform(-1, 1, (3, 3))
    X = rng.normal(size=(3, 6))
    np.testing.assert_allclose(
        tgs.lum_pose_corrections(pos, theta, X),
        np.asarray(jgs.lum_pose_corrections(pos, theta, X)), atol=1e-12,
    )


def test_read_net_graph_matches_jax(tmp_path):
    p = tmp_path / "g.net"
    p.write_text("4\n3\n0 1\n1 2\n3 0\n")
    links = tgs.read_net_graph(str(p))
    np.testing.assert_array_equal(links, jgs.read_net_graph(str(p)))
    np.testing.assert_array_equal(links, [[0, 1], [1, 2], [3, 0]])
    assert links.dtype == np.int32
    bad = tmp_path / "bad.net"
    bad.write_text("2\n1\n0 5\n")
    with pytest.raises(ValueError):
        tgs.read_net_graph(str(bad))


def _link_input(rng):
    # tests/test_graphslam.py:211 (test_link_covariances_chained_matches_brute)
    S, N = 3, 1600
    pts = np.zeros((S, N, 3), np.float32)
    masks = np.zeros((S, N), bool)
    for i in range(S):
        c = make_room_cloud(rng, n=N, size=700.0)
        c += np.array([i * 5.0, 0, 0])
        n = min(len(c), N) - i * 80  # ragged
        pts[i, :n] = c[:n]
        masks[i, :n] = True
    links = np.array([[0, 1], [1, 2], [0, 2]], np.int32)
    spec = npl.cell_list_spec(
        np.concatenate([pts[i][masks[i]] for i in range(S)]),
        50.0, headroom=2.0,
        queries=[pts[i][masks[i]] for i in range(S)],
    )
    return pts, masks, links, spec


def test_link_covariances_chained_matches_jax_and_brute(rng):
    pts, masks, links, spec = _link_input(rng)
    md2 = 2500.0
    jC, jCD, jm, jguard = jgs.link_covariances_chained(
        jnp.asarray(pts), jnp.asarray(masks), links, md2, spec
    )
    metrics.reset()
    tC, tCD, tm, tguard = tgs.link_covariances_chained(
        _t(pts), _t(masks), links, md2, spec
    )
    assert not jguard and not tguard
    assert int(metrics.counters[tgs.CHAINED_LINK_CALLS].total) == len(links)
    np.testing.assert_array_equal(tm, jm)
    bC, bCD, bm = tgs.link_covariances(_t(pts), _t(masks), links, md2)
    np.testing.assert_array_equal(tm, bm.numpy())
    for k in range(len(links)):
        assert np.linalg.norm(tC[k] - jC[k]) < 0.05 * np.linalg.norm(jC[k])
        assert np.linalg.norm(tCD[k] - jCD[k]) < 0.05 * (np.linalg.norm(jCD[k]) + 1.0)
        np.testing.assert_allclose(tC[k], bC[k].numpy(), rtol=1e-5, atol=1e-5 * np.abs(tC[k]).max())
        np.testing.assert_allclose(tCD[k], bCD[k].numpy(), rtol=1e-5, atol=1e-5 * np.abs(tCD[k]).max())
    # the JAX brute covariances too (exact ranking on both sides)
    C0, CD0, m0 = jgs.link_covariances(
        jnp.asarray(pts), jnp.asarray(masks), jnp.asarray(links), jnp.float32(md2)
    )
    np.testing.assert_array_equal(tm, np.asarray(m0))
    for k in range(len(links)):
        assert np.linalg.norm(tC[k] - np.asarray(C0[k])) < 1e-3 * np.linalg.norm(np.asarray(C0[k]))


def _ring_scans(rng, n=5, noise_t=3.0, noise_r=0.01):
    # tests/test_graphslam.py:29-50
    world = make_room_cloud(rng, n=3000, size=800.0)
    scans = []
    for k in range(n):
        ang = 0.25 * k
        pos = np.array([300 * np.cos(ang), 0.0, 300 * np.sin(ang)])
        theta = np.array([0.0, 0.1 * k, 0.0])
        T_true = np.asarray(jmath.euler_to_matrix4(pos, theta))
        local = np.asarray(jmath.transform3(jmath.m4inv(T_true), world))
        if k == 0:
            T0 = T_true
        else:
            nt = rng.uniform(-noise_t, noise_t, 3)
            nr = rng.uniform(-noise_r, noise_r, 3)
            T0 = np.asarray(jmath.euler_to_matrix4(nt, nr)) @ T_true
        s = TPUScan.from_points(local, f"{k:03d}", pose=T0)
        s.set_reduction(15.0, 1)
        s.reduced_local()
        scans.append(s)
    return scans


def _carry(jscans):
    return interop.scans_from_numpy(
        [
            {"identifier": s.identifier, "xyz": s.xyz,
             "reduced_local": s.reduced_local(), "transMatOrg": s.transMatOrg,
             "transMat": s.transMat, "reduction_voxel": s.reduction_voxel,
             "reduction_nrpts": s.reduction_nrpts}
            for s in jscans
        ]
    )[0]


@pytest.mark.parametrize("engine", ["brute", "chained"])
def test_do_graph_slam_matches_jax_host(rng, engine):
    jscans = _ring_scans(rng)
    tscans = _carry(jscans)
    links = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [0, 4], [0, 2]], np.int32)
    kw = dict(max_dist_match2=2500.0, iterations=5, epsilon=1e-3)
    jret = jgs._do_graph_slam_host(jscans, links, jgs.LumParams(mesh=None, **kw))
    metrics.reset()
    tret = tgs.do_graph_slam(
        tscans, links,
        tgs.LumParams(device="cpu", chained_min=512 if engine == "chained" else 98304, **kw),
    )
    calls = int(metrics.counters[tgs.CHAINED_LINK_CALLS].total)
    n_it = len(tscans[0].frames)
    assert calls == (len(links) * n_it if engine == "chained" else 0)
    assert tret == pytest.approx(jret, abs=1e-3)
    for j, t in zip(jscans, tscans):
        np.testing.assert_allclose(t.transMat[:3, 3], j.transMat[:3, 3], atol=0.05)
        np.testing.assert_allclose(t.transMat[:3, :3], j.transMat[:3, :3], atol=1e-5)
        assert [f[1] for f in t.frames] == [f[1] for f in j.frames]
        assert t.frames[-1][1] == int(AlgoType.LUM)


def test_host_lum_guard_respecs_from_the_current_clouds(rng, monkeypatch):
    """A guard that fires in the first iteration re-sizes the link spec
    with headroom 4 from the current global clouds, as tensors on their
    device: the JAX package's spec of the same clouds, entry for entry."""
    from tpu3dtk.ops import nn_pallas as npl

    jscans = _ring_scans(rng)
    links = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [0, 4], [0, 2]], np.int32)
    params = tgs.LumParams(
        device="cpu", chained_min=512, max_dist_match2=2500.0, iterations=5, epsilon=1e-3
    )
    link_spec, covariances = tgs._link_spec, tgs.link_covariances_chained
    specs = []

    def spying_spec(clouds, links, max_dist, headroom, device):
        got = link_spec(clouds, links, max_dist, headroom, device)
        host = [np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c) for c in clouds]
        want = npl.cell_list_spec(
            np.concatenate(host), max_dist, headroom=headroom, model_sets=host,
            queries=host, pairs=[(int(i), int(j)) for i, j in links],
        )
        specs.append((headroom, isinstance(clouds[0], torch.Tensor), got, want))
        return got

    def first_guard_fires(*a, **kw):
        C, CD, m, guard = covariances(*a, **kw)
        return C, CD, m, guard or len(specs) == 1

    monkeypatch.setattr(tgs, "_link_spec", spying_spec)
    monkeypatch.setattr(tgs, "link_covariances_chained", first_guard_fires)
    metrics.reset()
    scans = _carry(jscans)
    tgs.do_graph_slam(scans, links, params)
    assert [(h, on_device) for h, on_device, _g, _w in specs] == [(2.0, False), (4.0, True)]
    for _h, _d, got, want in specs:
        assert got is not None and set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    n_it = len(scans[0].frames)
    assert int(metrics.counters[tgs.CHAINED_LINK_CALLS].total) == len(links) * (n_it + 1)


def test_do_graph_slam_trivial_inputs():
    s = _carry([])
    assert tgs.do_graph_slam(s, np.zeros((0, 2), np.int32), tgs.LumParams(device="cpu")) == 0.0


def test_cli_net_matches_jax_cli(tmp_path):
    from tpu3dtk.cli import slam6d as jcli
    from tpu3dtk_torch.cli import slam6d as tcli

    locs, _true, odo = synth.synth_loop(n_scans=60, n_pts=1500, seed=3)
    d = tmp_path / "scans"
    synth.write_scan_dir(str(d), locs[:4], odo[:4])
    net = str(d / "loop.net")
    synth.write_net_graph(net, 4, [(0, 1), (1, 2), (2, 3), (0, 3)])
    flags = ["-f", "uos", "-r", "25", "-O", "0", "-d", "50", "-i", "30",
             "--epsICP", "1e-6", "-q", "-n", net, "-I", "3", "-D", "50",
             "--epsSLAM", "1e-9"]
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    jout.mkdir()
    tout.mkdir()
    assert jcli.main([str(d), *flags, "--frames-out", str(jout)]) == 0
    assert tcli.main([str(d), *flags, "--frames-out", str(tout), "--device", "cpu"]) == 0
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout)) and len(names) == 4
    for n in names:
        jm, jt = jframes.read_frames(str(jout / n))
        tm, tt = tframes.read_frames(str(tout / n))
        np.testing.assert_array_equal(tt, jt)
        assert list(tt[-3:]) == [int(AlgoType.LUM)] * 3
        assert int(AlgoType.ICP) in list(tt) or n == names[0]
        np.testing.assert_allclose(tm[-1][:3, 3], jm[-1][:3, 3], atol=0.5)
        np.testing.assert_allclose(tm[-1][:3, :3], jm[-1][:3, :3], atol=1e-3)
