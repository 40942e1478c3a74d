"""Normals and normals-based pairing of the port against the JAX
package's, on the same numpy inputs.

Bounds:
- ``knn_brute``: the sets of the k nearest equal the JAX package's for
  every query whose k-th and (k+1)-th exact distances are apart by more
  than the JAX expansion's f32 rounding (1e-2 cm² here; the port ranks
  on direct differences); their distances within 1e-2 cm².
- ``sym3_eigenvalues`` / ``smallest_eigenvector_sym3``: 1e-4 relative /
  the same axis within 1e-3 rad (both closed forms in f32).
- ``estimate_normals_knn`` and ``Scan.reduced_normals_local``: within
  1e-3 rad of the JAX normals where the neighbour sets agree, and the
  sets agree for at least 99% of the points.
- (``icp_pair`` with the normals pairings and napx: tests/test_torch_icp.py.)
- SequenceRegistration with each normals mode on the JAX package's
  reduced points and normals: poses within 0.05 cm / 1e-4, iterations
  within 1; ``torchslam --plane`` against ``tpuslam --plane``: within
  0.5 cm / 1e-3, the CLI bound of tests/test_torch_sequence.py (each
  package reduces the scans and estimates the normals itself); napx
  stays on the brute engine, where the JAX package's chained engine
  fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_room_cloud
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.models import icp as jicp
from tpu3dtk.ops import knn as jknn
from tpu3dtk.ops import normals as jnormals
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import icp as ticp
from tpu3dtk_torch.models import sequence as tseq
from tpu3dtk_torch.ops import knn as tknn
from tpu3dtk_torch.ops import normals as tnormals


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The clouds here are small: one intra-op thread is faster than
    eight, and does not fight the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _angle(a, b):
    """Angle (rad) between unit vectors, row by row."""
    c = np.clip(np.abs((a * b).sum(-1)), 0.0, 1.0)
    return np.arccos(c)


def _room(seed, n=1500):
    rng = np.random.default_rng(seed)
    cloud = make_room_cloud(rng, n=n, size=300.0).astype(np.float32)
    return cloud - cloud.mean(0)  # centred: the JAX expansion rounds less


@pytest.mark.parametrize("k", [1, 5, 20])
def test_knn_brute_sets_match_jax(k):
    rng = np.random.default_rng(k)
    q = rng.uniform(-50, 50, (300, 3)).astype(np.float32)
    m = rng.uniform(-50, 50, (700, 3)).astype(np.float32)
    mm = rng.uniform(size=700) > 0.1
    ti, td = tknn.knn_brute(_t(q), _t(np.ones(300, bool)), _t(m), _t(mm), k)
    ji, jd = jknn.knn_brute(jnp.asarray(q), jnp.ones(300, bool), jnp.asarray(m), jnp.asarray(mm), k=k)
    ti, td, ji = ti.numpy(), td.numpy(), np.asarray(ji)
    exact = ((q[:, None].astype(np.float64) - m[None]) ** 2).sum(-1)
    exact[:, ~mm] = np.inf
    srt = np.sort(exact, axis=1)
    clear = srt[:, k] - srt[:, k - 1] > 1e-2
    assert clear.mean() > 0.95
    for r in np.flatnonzero(clear):
        assert set(ti[r]) == set(ji[r].tolist())
    assert mm[ti].all()
    np.testing.assert_allclose(td, srt[:, :k], atol=1e-2)
    assert (np.diff(td, axis=1) >= 0).all()


def test_sym3_eigen_match_jax():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(200, 3, 3))
    A = (A @ A.transpose(0, 2, 1) + np.diag([3.0, 2.0, 0.1])).astype(np.float32)
    tl = tnormals.sym3_eigenvalues(_t(A)).numpy()
    jl = np.asarray(jnormals.sym3_eigenvalues(jnp.asarray(A)))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl, np.linalg.eigvalsh(A.astype(np.float64)), rtol=1e-3, atol=1e-3)
    tv = tnormals.smallest_eigenvector_sym3(_t(A)).numpy()
    jv = np.asarray(jnormals.smallest_eigenvector_sym3(jnp.asarray(A)))
    assert _angle(tv, jv).max() < 1e-3
    iso = tnormals.smallest_eigenvector_sym3(_t(np.eye(3, dtype=np.float32)[None])).numpy()
    np.testing.assert_array_equal(iso, [[0.0, 1.0, 0.0]])


def _same_sets(pts, mask, k):
    ti, _ = tknn.knn_brute(_t(pts), _t(mask), _t(pts), _t(mask), k)
    ji, _ = jknn.knn_brute(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts),
                           jnp.asarray(mask), k=k)
    return np.array([set(a) == set(b.tolist()) for a, b in zip(ti.numpy(), np.asarray(ji))])


@pytest.mark.parametrize("k", [12, 20])
def test_estimate_normals_knn_matches_jax(k):
    cloud = _room(k)
    cap = 1536
    pts = np.zeros((cap, 3), np.float32)
    pts[: len(cloud)] = cloud
    mask = np.arange(cap) < len(cloud)
    vp = np.array([10.0, 20.0, -5.0], np.float32)
    tn = tnormals.estimate_normals_knn(_t(pts), _t(mask), _t(vp), k=k).numpy()
    jn = np.asarray(jnormals.estimate_normals_knn(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(vp), k=k))
    same = _same_sets(pts, mask, k) & mask
    assert same.sum() >= 0.99 * mask.sum()
    assert _angle(tn[same], jn[same]).max() < 1e-3
    # oriented alike (toward the viewpoint), unit length, zero where masked
    assert ((tn[same] * jn[same]).sum(1) > 0).all()
    np.testing.assert_allclose(np.linalg.norm(tn[mask], axis=1), 1.0, atol=1e-5)
    assert not tn[~mask].any()
    # numpy input: uploaded to the given device
    tn2 = tnormals.estimate_normals_knn(pts, mask, vp, k=k, device="cpu")
    np.testing.assert_array_equal(tn2.numpy(), tn)


def test_scan_reduced_normals_match_jax():
    rng = np.random.default_rng(8)
    cloud = make_room_cloud(rng, n=2500, size=400.0)
    js = TPUScan.from_points(cloud, "000")
    js.set_reduction(15.0, 1)
    jr = js.reduced_local()
    ts = interop.scans_from_numpy([{"identifier": "000", "xyz": cloud, "reduced_local": jr}])[0][0]
    ts.device = "cpu"
    tn, jn = ts.reduced_normals_local(), js.reduced_normals_local()
    assert tn.shape == jn.shape == jr.shape and tn.dtype == np.float64
    r = jr.astype(np.float32)
    same = _same_sets(r, np.ones(len(r), bool), 20)
    assert same.mean() >= 0.99
    assert _angle(tn[same], jn[same]).max() < 1e-3
    assert ts.reduced_normals_padded(len(r) + 7)[len(r):].sum() == 0
    # the channel crosses with interop, and a new reduction drops it
    carried = interop.scans_from_numpy([{
        "identifier": "000", "xyz": cloud, "reduced_local": jr, "normal reduced": jn}])[0][0]
    np.testing.assert_array_equal(carried.reduced_normals_local(), jn)
    carried.set_reduction(20.0, 1)
    assert "normal reduced" not in carried.channels


def _loop_scans():
    """4 synth_loop scans reduced by the JAX package, with its normals."""
    from tpu3dtk_torch import synth

    locs, _true, odo = synth.synth_loop(n_scans=4, n_pts=1500, seed=4)
    jscans = []
    for k, (loc, To) in enumerate(zip(locs, odo)):
        s = TPUScan.from_points(loc, f"{k:03d}", pose=To)
        s.set_reduction(20.0, 0)
        s.reduced_normals_local()
        jscans.append(s)
    return jscans


@pytest.mark.parametrize("kw", [
    dict(pairing="closest_plane"), dict(minimizer="lumquat"), dict(minimizer="napx"),
])
def test_sequence_normals_match_jax(kw):
    """SequenceRegistration's resident normals upload, on the JAX
    package's reduced points and normals (carried by interop), and a
    pose minimizer through it.  (Normal shooting slides freely along
    these corridor walls: two f32 orders drift apart by metres over 30
    iterations in either package, so its bound is icp_pair's above.)"""
    from tpu3dtk.models.sequence import SequenceRegistration as JSeq

    jscans = _loop_scans()
    tscans = interop.scans_from_numpy([
        {"identifier": s.identifier, "xyz": s.xyz, "reduced_local": s.reduced_local(),
         "normal reduced": s.reduced_normals_local(), "transMatOrg": s.transMatOrg}
        for s in jscans
    ])[0]
    base = dict(max_dist_match2=2500.0, max_iterations=30, epsilon=1e-6)
    jres = JSeq(params=jicp.IcpParams(**base, **kw)).run(jscans)
    reg = tseq.SequenceRegistration(params=ticp.IcpParams(**base, **kw), device="cpu")
    tres = reg.run(tscans)
    normals = reg._prep["normals"]
    if kw.get("minimizer") == "lumquat":
        assert normals is None  # no upload where nothing reads them
    else:
        assert normals.shape == reg._prep["locals"].shape
    for t, j in zip(tscans, jscans):
        np.testing.assert_allclose(t.transMat[:3, 3], j.transMat[:3, 3], atol=0.05)
        np.testing.assert_allclose(t.transMat[:3, :3], j.transMat[:3, :3], atol=1e-4)
    for t, j in zip(tres, jres):
        assert abs(t["iterations"] - j["iterations"]) <= 1


@pytest.mark.parametrize("flags", [["--plane"], ["-a", "10"], ["--normalShoot"]])
def test_cli_normals_match_jax_cli(tmp_path, flags):
    """torchslam with the normals flags: exit 0, ICP frames, finite
    poses; --plane within 0.5 cm / 1e-3 of tpuslam (each package reduces
    and estimates normals itself; napx and normal shooting react to the
    few neighbour sets that differ by more than that on this loop)."""
    import os

    from tpu3dtk.cli import slam6d as jcli
    from tpu3dtk.io import frames as jframes
    from tpu3dtk_torch import synth
    from tpu3dtk_torch.cli import slam6d as tcli
    from tpu3dtk_torch.io import frames as tframes
    from tpu3dtk_torch.io.frames import AlgoType

    locs, _true, odo = synth.synth_loop(n_scans=4, n_pts=1500, seed=4)
    d = tmp_path / "scans"
    synth.write_scan_dir(str(d), locs, odo)
    common = [str(d), "-f", "uos", "-r", "20", "-O", "0", "-d", "50", "-i", "30",
              "--epsICP", "1e-6", "-q", *flags]
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    jout.mkdir()
    tout.mkdir()
    assert tcli.main([*common, "--frames-out", str(tout), "--device", "cpu"]) == 0
    if flags == ["--plane"]:
        assert jcli.main([*common, "--frames-out", str(jout)]) == 0
    names = sorted(os.listdir(tout))
    assert len(names) == 4
    for n in names:
        tm, tt = tframes.read_frames(str(tout / n))
        assert np.isfinite(tm).all() and int(AlgoType.ICP) in [int(v) for v in tt] or n == names[0]
        if flags == ["--plane"]:
            jm, _ = jframes.read_frames(str(jout / n))
            np.testing.assert_allclose(tm[-1][:3, 3], jm[-1][:3, 3], atol=0.5)
            np.testing.assert_allclose(tm[-1][:3, :3], jm[-1][:3, :3], atol=1e-3)


def test_napx_stays_on_the_brute_engine(monkeypatch):
    """The chained gate: napx, lumeuler and lumquat never take K2 (a
    spec that always fits stands in for the sizing)."""
    from tpu3dtk_torch.ops import nn_cell_list as ncl

    monkeypatch.setattr(ncl, "cell_list_spec", lambda *a, **k: {"RB": 1})
    for name in ("napx", "lumeuler", "lumquat", "quat"):
        reg = tseq.SequenceRegistration(
            params=ticp.IcpParams(minimizer=name), device="cpu", chained_min=1)
        rng = np.random.default_rng(2)
        from tpu3dtk_torch.core.scan import Scan

        scans = [Scan.from_points(make_room_cloud(rng, n=600), f"{k:03d}") for k in range(2)]
        for s in scans:
            s.device = "cpu"
        spec = reg._chain_spec(scans, 1024)
        assert (spec is None) == (name != "quat"), name
