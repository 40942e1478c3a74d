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


def _unfactored_icp_pair(model, mmask, target_local, tmask, T0, *, max_dist_match2, epsilon,
                     max_iterations=50, minimizer="quat", pairing="closest_point",
                     target_normals_local=None):
    """The eager loop ``icp_pair`` ran before its iteration was factored
    into ``_icp_step`` (no group, no -R): the reference the factored loop
    is held to bit for bit.  Also returns which test stopped it."""
    from tpu3dtk_torch.core import math3d
    from tpu3dtk_torch.models import minimizers as mz
    from tpu3dtk_torch.ops import nn as tnn

    need_normals = pairing != "closest_point" or minimizer == "napx"
    align_fn = mz.get_minimizer(minimizer)
    bm = tnn.prepare_brute_model(model.to(torch.float32).contiguous(), mmask)
    target_local = target_local.to(torch.float32)
    T = torch.as_tensor(T0, dtype=torch.float32)
    eps = float(np.float32(epsilon))
    md2 = float(np.float32(max_dist_match2))
    eye4 = torch.eye(4, dtype=torch.float32)
    ret = prev = prev2 = 0.0
    npairs = 0.0
    it = 0
    done = False
    why = "iterations"
    while not done and it < max_iterations:
        tgt_global = math3d.transform3(T, target_local)
        normals_g = None
        if need_normals:
            normals_g = math3d.transform3normal(T, target_normals_local).to(torch.float32)
        m_pts, found = ticp._find_pairs(bm, tgt_global, tmask, md2, pairing, normals_g)
        stats = mz.pair_stats(m_pts, tgt_global, found)
        align, err = align_fn(stats)
        n, err_v, tnorm, rnorm = torch.stack([
            stats.n.double(),
            err.double(),
            torch.linalg.norm(align[:3, 3]).double(),
            torch.linalg.norm(align[:3, :3] - eye4[:3, :3]).double(),
        ]).tolist()
        enough = n > 3
        if enough:
            T = align @ T
        prev2, prev = prev, ret
        if enough:
            ret = err_v
        conv = abs(ret - prev) < eps and abs(ret - prev2) < eps
        pose_conv = tnorm < ticp._POSE_T and rnorm < ticp._POSE_R
        done = conv or (pose_conv and enough) or not enough
        if done:
            why = "pairs" if not enough else "two-delta" if conv else "pose"
        npairs = n
        it += 1
    return ticp.IcpResult(T=T, error=ret, iterations=it, n_pairs=npairs), why


def _assert_same_result(a, b):
    assert torch.equal(a.T, b.T)
    assert a.error == b.error and a.iterations == b.iterations and a.n_pairs == b.n_pairs


# every capture-safe pair to convergence, then the two stops that end a
# match early: too few pairs, and the pose fixpoint (epsilon 0 leaves the
# two-delta test out)
_STEP_CASES = [(m, p, "converged") for m, p in sorted(ticp.GRAPH_SAFE)] + [
    ("quat", "closest_point", "pairs"),
    ("quat", "closest_point", "pose"),
]


@pytest.mark.parametrize("minimizer,pairing,stop", _STEP_CASES)
def test_icp_step_loop_equals_the_unfactored_loop(minimizer, pairing, stop):
    """``icp_pair`` on the CPU runs ``_icp_step`` in the host's stop loop:
    the same pose, error, iterations and pairs as the unfactored loop."""
    from tpu3dtk_torch.utils.metrics import BRUTE_ICP_ITERATIONS, ICP_GRAPH_REPLAYS, metrics

    pts, mask, normals, T0 = _pair_case(21)
    model = pts + 10000.0 if stop == "pairs" else pts
    args = (_t(model), _t(mask), _t(pts), _t(mask), _t(T0))
    kw = dict(max_dist_match2=625.0, epsilon=0.0 if stop == "pose" else 1e-7,
              max_iterations=80, minimizer=minimizer, pairing=pairing,
              target_normals_local=_t(normals))
    ref, why = _unfactored_icp_pair(*args, **kw)
    its, reps = (metrics.counters[k].total for k in (BRUTE_ICP_ITERATIONS, ICP_GRAPH_REPLAYS))
    got = ticp.icp_pair(*args, **kw)
    _assert_same_result(got, ref)
    assert metrics.counters[BRUTE_ICP_ITERATIONS].total == its + got.iterations
    assert metrics.counters[ICP_GRAPH_REPLAYS].total == reps  # the CPU runs eagerly
    if stop == "converged":
        assert why in ("two-delta", "pose") and got.iterations > 2
    else:
        assert why == stop


_CUDA = torch.device("cuda")  # a device name: no card needed


@pytest.mark.parametrize("device,subsample,group,minimizer,pairing,graph", [
    (_CUDA, 1, None, "quat", "closest_point", True),
    (_CUDA, 1, None, "dual", "closest_plane", True),
    (torch.device("cpu"), 1, None, "quat", "closest_point", False),
    (_CUDA, 2, None, "quat", "closest_point", False),
    (_CUDA, 1, "a process group", "quat", "closest_point", False),
    (_CUDA, 1, None, "svd", "closest_point", False),
    (_CUDA, 1, None, "napx", "closest_plane", False),
    (_CUDA, 1, None, "quat", "along_normal", False),
])
def test_graph_path_choice(device, subsample, group, minimizer, pairing, graph):
    """The graph path runs on a card only, and only where the iteration
    reads nothing from the host: no collective, no -R draw, a minimizer
    and pairing of GRAPH_SAFE."""
    assert ticp._graph_path(device, subsample, group, minimizer, pairing) is graph


class _FakeCapture(ticp._CapturedIteration):
    """A captured iteration without a card: a replay runs the captured
    step eagerly on the static tensors, which is what the graph replays."""

    made = []

    def __init__(self, step, bm, target_local, tmask, T, normals):
        import weakref

        self.step = step
        self.bm = ticp.nn_ops.BruteModel(*(x.clone() for x in bm))
        self.target, self.tmask, self.T = target_local.clone(), tmask.clone(), T.clone()
        self.normals = None if normals is None else normals.clone()
        _FakeCapture.made.append(weakref.ref(self))

    @classmethod
    def first(cls, step, bm, target_local, tmask, T, normals):
        T, stop = step(bm, target_local, tmask, T, normals)
        return T, stop, cls(step, bm, target_local, tmask, T, normals)

    def replay(self):
        T_next, stop = self.step(self.bm, self.target, self.tmask, self.T, self.normals)
        self.T.copy_(T_next)
        return stop


def test_graph_cache_with_a_fake_capture(monkeypatch):
    """The graph path's control flow on the CPU, a fake capture in the
    graph's place: a shape's first match runs eagerly, its second
    captures, a later one reuses the capture and replays every
    iteration; past the cache's bound the least recently used capture
    is dropped, and past the bound of remembered shapes the oldest is
    forgotten and runs eagerly again.  Every match equals the eager one."""
    from tpu3dtk_torch.utils.metrics import BRUTE_ICP_ITERATIONS, ICP_GRAPH_REPLAYS, metrics

    pts, mask, _n, T0 = _pair_case(22)
    T1 = np.asarray(jm3.euler_to_matrix4([-3.0, 2.0, 1.0], [0.0, 0.01, 0.01], xp=np), np.float32)
    kw = dict(max_dist_match2=625.0, epsilon=1e-7, max_iterations=60)
    rows = {"a": 2048, "b": 1536, "c": 1024, "d": 512}

    def match(name, T):
        r = rows[name]
        return ticp.icp_pair(_t(pts), _t(mask), _t(pts[:r]), _t(mask[:r]), _t(T), **kw)

    # (shape, start, how its iterations run, captures made, shapes cached)
    plan = [
        ("a", T0, "eager", 0, ""), ("a", T1, "capture", 1, "a"), ("a", T0, "replay", 1, "a"),
        ("b", T1, "eager", 1, "a"), ("b", T0, "capture", 2, "ab"),
        ("c", T1, "eager", 2, "ab"), ("c", T0, "capture", 3, "bc"),  # "a" dropped
        ("d", T0, "eager", 3, "bc"),  # "a" forgotten: 3 shapes remembered
        ("a", T1, "eager", 3, "bc"), ("a", T0, "capture", 4, "ca"),
    ]
    eager = [match(name, T) for name, T, *_ in plan]

    cache = ticp.GraphCache(2, seen_cap=3)
    monkeypatch.setattr(ticp, "_GRAPHS", cache)
    monkeypatch.setattr(ticp, "_graph_path", lambda *a: True)
    monkeypatch.setattr(ticp, "_CapturedIteration", _FakeCapture)
    monkeypatch.setattr(_FakeCapture, "made", [])
    for (name, T, how, n_made, cached), ref in zip(plan, eager):
        its, reps = (metrics.counters[k].total for k in (BRUTE_ICP_ITERATIONS, ICP_GRAPH_REPLAYS))
        got = match(name, T)
        _assert_same_result(got, ref)
        assert len(_FakeCapture.made) == n_made
        assert [k[1] for k in cache.entries] == [rows[c] for c in cached]
        assert all(k[2:] == (2048, 625.0, "quat", "closest_point") for k in cache.entries)
        assert metrics.counters[BRUTE_ICP_ITERATIONS].total == its + got.iterations
        replayed = {"eager": 0, "capture": got.iterations - 1, "replay": got.iterations}[how]
        assert metrics.counters[ICP_GRAPH_REPLAYS].total == reps + replayed
    # the dropped capture of "a" is freed with its static tensors
    assert _FakeCapture.made[0]() is None and _FakeCapture.made[3]() is not None
    assert ticp._GRAPHS is cache and cache.cap == 2 and len(cache.seen) == 3


@pytest.mark.parametrize("minimizer,pairing", sorted(ticp.GRAPH_SAFE))
def test_icp_step_reads_nothing_from_the_host(minimizer, pairing, monkeypatch):
    """What a CUDA graph can hold: the iteration of every capture-safe
    pair makes no scalar read, no copy to host data and builds no tensor
    from host data.  On the CPU a ``.tolist()``, ``.numpy()`` or
    ``.cpu()`` dispatches nothing, so those, and the reads behind a
    Python ``bool``, ``int`` or ``float`` of a tensor, raise here."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def host_read(*a, **k):
        raise AssertionError("a host read inside the ICP iteration")

    for name in ("tolist", "numpy", "cpu", "item", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.name())
            return func(*args, **(kwargs or {}))

    pts, mask, normals, T0 = _pair_case(23)
    bm = ticp.nn_ops.prepare_brute_model(_t(pts), _t(mask))
    nrm = _t(normals) if pairing != "closest_point" else None
    args = (bm, _t(pts), _t(mask), _t(T0), nrm)
    with Ops() as ops:
        T, stop = ticp._icp_step(*args, 625.0, minimizer, pairing)
    assert len(ops.names) > 20 and T.shape == (4, 4) and stop.dtype == torch.float64
    assert not [n for n in ops.names if n in ("aten::_local_scalar_dense", "aten::lift_fresh")]
