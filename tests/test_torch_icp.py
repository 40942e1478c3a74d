"""The port's ICP loop against the JAX package's on the same clouds.

Bounds (tests/test_graph_pipeline_device.py:103-109): poses within
0.5 cm translation and 1e-3 on rotation entries; iteration counts within
±1, since f32 sums in another order can move a stop test by one
iteration.  The normals pairings (``closest_plane``, ``along_normal``)
and the napx, lumeuler and lumquat minimizers, on the JAX package's
normals: poses within 0.05 cm / 1e-4, iterations within 1."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import make_room_cloud
from tpu3dtk.core import math3d as jm3
from tpu3dtk.models import icp as jicp
from tpu3dtk.ops import normals as jnormals
from tpu3dtk_torch.models import icp as ticp


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


def _pad(pts, cap):
    out = np.zeros((cap, 3), np.float32)
    out[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    return out, mask


def _both(model, mmask, target, tmask, T0, **kw):
    jr = jicp.icp_pair(
        jnp.asarray(model), jnp.asarray(mmask), jnp.asarray(target),
        jnp.asarray(tmask), jnp.asarray(T0), **kw,
    )
    tr = ticp.icp_pair(
        torch.as_tensor(model), torch.as_tensor(mmask), torch.as_tensor(target),
        torch.as_tensor(tmask), torch.as_tensor(T0), **kw,
    )
    return jr, tr


def _assert_close(jr, tr):
    jT, tT = np.asarray(jr.T), tr.T.numpy()
    np.testing.assert_allclose(tT[:3, 3], jT[:3, 3], atol=0.5)
    np.testing.assert_allclose(tT[:3, :3], jT[:3, :3], atol=1e-3)
    assert abs(tr.iterations - int(jr.iterations)) <= 1


@pytest.mark.parametrize("minimizer", ["quat", "svd"])
def test_icp_pair_matches_jax(minimizer):
    rng = np.random.default_rng(42)
    cloud = make_room_cloud(rng, n=3000)
    noisy = cloud + rng.normal(0, 0.5, cloud.shape)
    T_pert = np.asarray(
        jm3.euler_to_matrix4([8.0, -5.0, 6.0], [0.02, -0.03, 0.015], xp=np),
        np.float32,
    )
    model, mmask = _pad(cloud, 3072)
    target, tmask = _pad(noisy, 3072)
    jr, tr = _both(
        model, mmask, target, tmask, T_pert,
        max_dist_match2=625.0, epsilon=1e-6, max_iterations=50,
        minimizer=minimizer,
    )
    _assert_close(jr, tr)
    np.testing.assert_allclose(tr.T.numpy(), np.eye(4), atol=0.1)
    assert abs(tr.error - float(jr.error)) < 1e-3
    assert tr.n_pairs == pytest.approx(float(jr.n_pairs), abs=5)
    assert isinstance(tr.error, float)


def test_icp_pair_prepares_the_model_once(monkeypatch):
    """The model is centred and packed once per match, every iteration
    ranks against that prepared model, and the result is the one a model
    prepared anew in every iteration gives."""
    from tpu3dtk_torch.ops import nn as tnn

    rng = np.random.default_rng(7)
    cloud = make_room_cloud(rng, n=2000)
    model, mmask = _pad(cloud, 2048)
    target, tmask = _pad(cloud + rng.normal(0, 0.5, cloud.shape), 2048)
    T0 = np.asarray(
        jm3.euler_to_matrix4([5.0, -3.0, 4.0], [0.01, -0.02, 0.01], xp=np), np.float32
    )
    args = [torch.as_tensor(a) for a in (model, mmask, target, tmask, T0)]
    kw = dict(max_dist_match2=625.0, epsilon=1e-6, max_iterations=50)
    calls = {"prepare": 0, "nn": 0}
    prepare, auto = tnn.prepare_brute_model, tnn.nn_brute_auto

    def counting_prepare(*a):
        calls["prepare"] += 1
        return prepare(*a)

    def counting_auto(query, qmask, model, mmask, max_dist2):
        calls["nn"] += 1
        assert isinstance(model, tnn.BruteModel) and mmask is None
        return auto(query, qmask, model, mmask, max_dist2)

    monkeypatch.setattr(tnn, "prepare_brute_model", counting_prepare)
    monkeypatch.setattr(tnn, "nn_brute_auto", counting_auto)
    tr = ticp.icp_pair(*args, **kw)
    assert calls["prepare"] == 1 and calls["nn"] == tr.iterations > 3

    def bare_pairs(bm, tgt_global, tmask, max_dist2, *_pairing):
        idx, _d2, found = auto(tgt_global, tmask, bm.model, bm.mmask, max_dist2)
        return bm.model[idx], found

    monkeypatch.setattr(ticp, "_find_pairs", bare_pairs)
    tr2 = ticp.icp_pair(*args, **kw)
    assert torch.equal(tr.T, tr2.T) and tr.iterations == tr2.iterations
    assert tr.error == tr2.error and tr.n_pairs == tr2.n_pairs
    np.testing.assert_allclose(tr.T.numpy(), np.eye(4), atol=0.1)


def test_icp_no_pairs_is_identity():
    rng = np.random.default_rng(1)
    cloud = make_room_cloud(rng, n=500)
    model, mmask = _pad(cloud, 512)
    target, tmask = _pad(cloud + 10000.0, 512)
    jr, tr = _both(
        model, mmask, target, tmask, np.eye(4, dtype=np.float32),
        max_dist_match2=100.0, epsilon=1e-6, max_iterations=10,
    )
    np.testing.assert_array_equal(tr.T.numpy(), np.eye(4))
    assert tr.iterations == int(jr.iterations) == 1
    assert tr.n_pairs == 0


def test_icp_subsample_converges():
    """-R: a fresh random subset per iteration (torch.Generator)."""
    rng = np.random.default_rng(2)
    cloud = make_room_cloud(rng, n=3000)
    model, mmask = _pad(cloud, 3072)
    T_pert = np.asarray(
        jm3.euler_to_matrix4([4.0, 3.0, -2.0], [0.01, 0.0, -0.01], xp=np),
        np.float32,
    )
    tr = ticp.icp_pair(
        torch.as_tensor(model), torch.as_tensor(mmask), torch.as_tensor(model),
        torch.as_tensor(mmask), torch.as_tensor(T_pert),
        max_dist_match2=625.0, epsilon=1e-6, max_iterations=60, subsample=2,
    )
    np.testing.assert_allclose(tr.T.numpy(), np.eye(4), atol=0.1)
    assert tr.n_pairs < 0.7 * mmask.sum()


def test_window_and_sequence_helpers_match_jax():
    """Model-window build and the two pose helpers of the device loop."""
    rng = np.random.default_rng(3)
    S, N = 4, 64
    locs = rng.normal(0, 100, (S, N, 3)).astype(np.float32)
    masks = rng.uniform(size=(S, N)) > 0.2
    mats = np.stack([
        jm3.euler_to_matrix4(rng.normal(0, 50, 3), rng.normal(0, 0.2, 3), xp=np)
        for _ in range(S)
    ]).astype(np.float32)
    for lo, hi, cap in [(1, 2, 1), (0, 3, 4), (2, 4, 2)]:
        jmodel, jmmask, *_ = jicp._seq_build(
            jnp.asarray(locs), jnp.asarray(masks), jnp.zeros((1, 1, 3)),
            jnp.asarray(mats), jnp.int32(lo), jnp.int32(hi), jnp.int32(hi),
            jnp.float32(625.0), has_normals=False, n_buckets=0, window_cap=cap,
        )
        tmodel, tmmask = ticp._window(
            torch.as_tensor(locs), torch.as_tensor(masks), torch.as_tensor(mats),
            lo, hi, cap,
        )
        np.testing.assert_array_equal(tmmask.numpy(), np.asarray(jmmask))
        np.testing.assert_allclose(tmodel.numpy(), np.asarray(jmodel), atol=1e-4)
    T = torch.as_tensor(mats[1])
    np.testing.assert_allclose(
        ticp._rigid_inv_f32(T).numpy(),
        np.asarray(jicp._rigid_inv_f32(jnp.asarray(mats[1]))), atol=1e-5,
    )
    np.testing.assert_allclose(
        ticp._orthonormalize_rot(T * 1.0001).numpy(),
        np.asarray(jicp._orthonormalize_rot(jnp.asarray(mats[1] * 1.0001))),
        atol=1e-5,
    )


def _pair_case(seed, plane=False):
    rng = np.random.default_rng(seed)
    cap = 2048
    if plane:  # one plane offset along its normal (tests/test_normals.py)
        cloud = rng.uniform(0, 500, (2000, 3)).astype(np.float32)
        cloud[:, 1] = 0.0
        nrm = np.zeros((len(cloud), 3), np.float32)
        nrm[:, 1] = 1.0
        T = jm3.euler_to_matrix4([0.0, 3.0, 0.0], [0.0, 0.0, 0.0], xp=np)
    else:
        cloud = make_room_cloud(rng, n=2000).astype(np.float32)
        nrm = np.asarray(jnormals.estimate_normals_knn(
            jnp.asarray(cloud), jnp.ones(len(cloud), bool),
            jnp.asarray([500.0, 500.0, 500.0], jnp.float32), k=12))
        T = jm3.euler_to_matrix4([4.0, -3.0, 2.0], [0.01, 0.015, -0.01], xp=np)
    pts = np.zeros((cap, 3), np.float32)
    pts[: len(cloud)] = cloud
    normals = np.zeros((cap, 3), np.float32)
    normals[: len(cloud)] = nrm
    mask = np.arange(cap) < len(cloud)
    return pts, mask, normals, np.asarray(T, np.float32)


@pytest.mark.parametrize("pairing,minimizer,plane", [
    ("closest_plane", "quat", False),
    ("along_normal", "quat", True),
    ("closest_point", "napx", False),
    ("closest_plane", "napx", False),
])
def test_icp_pair_normals_match_jax(pairing, minimizer, plane):
    pts, mask, normals, T0 = _pair_case(11, plane)
    kw = dict(max_dist_match2=625.0, epsilon=1e-7, max_iterations=80, pairing=pairing,
              minimizer=minimizer)
    jr = jicp.icp_pair(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts), jnp.asarray(mask),
                       jnp.asarray(T0), target_normals_local=jnp.asarray(normals), **kw)
    tr = ticp.icp_pair(_t(pts), _t(mask), _t(pts), _t(mask), _t(T0),
                       target_normals_local=_t(normals), **kw)
    jT, tT = np.asarray(jr.T), tr.T.numpy()
    np.testing.assert_allclose(tT[:3, 3], jT[:3, 3], atol=0.05)
    np.testing.assert_allclose(tT[:3, :3], jT[:3, :3], atol=1e-4)
    assert abs(tr.iterations - int(jr.iterations)) <= 1
    assert tr.iterations > 1
    if plane:  # normal shooting pulls the offset back along the normal
        assert abs(tT[1, 3]) < 0.1
    else:
        np.testing.assert_allclose(tT, np.eye(4), atol=0.1)


@pytest.mark.parametrize("minimizer", ["lumeuler", "lumquat"])
def test_icp_pose_minimizers_match_jax(minimizer):
    """lumeuler / lumquat get the current pose each iteration; the
    target sits far from the origin, so the pose Jacobian matters."""
    pts, mask, _n, _T = _pair_case(12)
    T_far = np.asarray(jm3.euler_to_matrix4([300.0, -40.0, 250.0], [0.1, 0.3, -0.05], xp=np))
    world = (pts @ T_far[:3, :3].T + T_far[:3, 3]).astype(np.float32)
    T0 = (np.asarray(jm3.euler_to_matrix4([3.0, -2.0, 2.0], [0.01, -0.01, 0.01], xp=np))
          @ T_far).astype(np.float32)
    kw = dict(max_dist_match2=625.0, epsilon=1e-7, max_iterations=60, minimizer=minimizer)
    jr = jicp.icp_pair(jnp.asarray(world), jnp.asarray(mask), jnp.asarray(pts), jnp.asarray(mask),
                       jnp.asarray(T0), **kw)
    tr = ticp.icp_pair(_t(world), _t(mask), _t(pts), _t(mask), _t(T0), **kw)
    jT, tT = np.asarray(jr.T), tr.T.numpy()
    np.testing.assert_allclose(tT[:3, 3], jT[:3, 3], atol=0.05)
    np.testing.assert_allclose(tT[:3, :3], jT[:3, :3], atol=1e-4)
    np.testing.assert_allclose(tT, T_far, atol=0.1)
    assert abs(tr.iterations - int(jr.iterations)) <= 1


def test_icp_pair_refuses_missing_normals():
    pts, mask, _n, T0 = _pair_case(13)
    for kw in (dict(pairing="closest_plane"), dict(minimizer="napx")):
        with pytest.raises(ValueError, match="normals"):
            ticp.icp_pair(_t(pts), _t(mask), _t(pts), _t(mask), _t(T0), max_dist_match2=625.0,
                          epsilon=1e-6, **kw)
    with pytest.raises(ValueError, match="chained"):
        ticp.icp_pair_chained(_t(pts), _t(mask), _t(pts), _t(mask), _t(T0),
                              max_dist_match2=625.0, epsilon=1e-6, minimizer="napx")


@pytest.fixture(scope="module")
def h468_pair():
    """Scans 0 and 1 of the h468 ring (``synth_ring(468, 16384, seed=11)``),
    reduced (-r 10 -O 1) and given normals (k = 20) by the JAX package:
    the model is scan 0 in the global frame, the target scan 1 in its
    local frame with its odometry pose."""
    from tpu3dtk.core.scan import TPUScan
    from tpu3dtk_torch import synth

    locs, true, odo = synth.synth_ring(468, 16384, seed=11, n_render=2)
    scans = []
    for k in range(2):
        s = TPUScan.from_points(locs[k], f"{k:03d}", pose=odo[k])
        s.set_reduction(10.0, 1)
        scans.append(s)
    T = np.asarray(odo[0], np.float32)
    model = (scans[0].reduced_local().astype(np.float32) @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return dict(
        model=model, target=scans[1].reduced_local().astype(np.float32),
        normals=scans[1].reduced_normals_local().astype(np.float32),
        T0=np.asarray(odo[1], np.float32), rel_true=np.linalg.inv(true[0]) @ true[1], pose0=odo[0],
    )


def test_icp_pair_dual_on_h468_matches_jax(h468_pair):
    """Dual quaternions (-a 4) on a real h468 pair, three iterations:
    the port's poses within 0.05 cm / 1e-4 of the JAX package's, and in
    both packages the match leaves the true relative pose by more than a
    metre (the minimizer works on uncentred f32 sums at ~4500 cm
    coordinates; chip_smoke phase 17 gates -a 4 on the JAX figure)."""
    p = h468_pair
    mm, tm = np.ones(len(p["model"]), bool), np.ones(len(p["target"]), bool)
    kw = dict(max_dist_match2=2500.0, epsilon=1e-9, max_iterations=3, minimizer="dual")
    jr = jicp.icp_pair(jnp.asarray(p["model"]), jnp.asarray(mm), jnp.asarray(p["target"]),
                       jnp.asarray(tm), jnp.asarray(p["T0"]), **kw)
    tr = ticp.icp_pair(_t(p["model"]), _t(mm), _t(p["target"]), _t(tm), _t(p["T0"]), **kw)
    jT, tT = np.asarray(jr.T), tr.T.numpy()
    np.testing.assert_allclose(tT[:3, 3], jT[:3, 3], atol=0.05)
    np.testing.assert_allclose(tT[:3, :3], jT[:3, :3], atol=1e-4)
    assert tr.iterations == int(jr.iterations) == 3
    for T in (jT, tT):
        rel = np.linalg.inv(p["pose0"]) @ T
        assert np.linalg.norm(rel[:3, 3] - p["rel_true"][:3, 3]) > 100.0


def test_line_nn_on_h468_matches_jax(h468_pair):
    """Normal shooting's pairing (``nn_brute_line``) on a real h468 pair
    at the odometry pose: the same accepted queries; the same winner for
    at least 99.8% of them; where the winners differ, their exact (f64)
    line distances lie within 4 f32 spacings of the largest squared
    distance among the winners: the metric |p−x|² − ((p−x)·n)² ties at
    f32 resolution, its partners lying anywhere along the ray.  So the
    normal-shooting ICP is not held pose for pose on these scans; a tie
    taken differently moves the next pose by (offset along the ray) /
    (pairs)."""
    from tpu3dtk.ops import nn as jnn
    from tpu3dtk_torch.ops import nn as tnn

    p = h468_pair
    T = p["T0"]
    q = (p["target"] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    qd = (p["normals"] @ T[:3, :3].T).astype(np.float32)
    mm, qm = np.ones(len(p["model"]), bool), np.ones(len(q), bool)
    ji, _jb, jf = (np.asarray(x) for x in jnn.nn_brute_line(
        jnp.asarray(q), jnp.asarray(qd), jnp.asarray(qm), jnp.asarray(p["model"]),
        jnp.asarray(mm), 2500.0))
    ti, _tb, tf = (x.numpy() for x in tnn.nn_brute_line(
        _t(q), _t(qd), _t(qm), _t(p["model"]), _t(mm), 2500.0))
    np.testing.assert_array_equal(tf, jf)
    assert jf.sum() > 0.9 * len(q)
    assert (ti[jf] == ji[jf]).mean() >= 0.998

    def line64(idx):
        d = p["model"][idx].astype(np.float64) - q
        pr = (d * qd).sum(1)
        return (d * d).sum(1) - pr * pr, (d * d).sum(1)

    (lj, rj), (lt, rt) = line64(ji), line64(ti)
    tol = 4 * float(np.spacing(np.float32(max(rj[jf].max(), rt[jf].max()))))
    assert np.abs(lt - lj)[jf].max() <= tol
