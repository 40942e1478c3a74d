"""ELCH loop closing of the port (``tpu3dtk_torch.models.elch`` and the
loop-closure windows of ``models.icp``) against the JAX package's, on
the same numpy inputs (the 8-scan drifting ring of tests/test_elch.py).

Bounds:
- ``graph_balancer``, ``_slerp``, ``_inv_diag_weights``: the same f64
  host code: 1e-12, on the chain, weighted chain and branch cases of
  tests/test_elch.py and on random graphs; the pure-Python Dijkstra
  equals scipy's.
- ``_window_build``: masks equal, points within 1e-3 cm (f32 transform).
- ``icp_window_align``: align within 0.01 cm / 1e-5.
- ``_edge_covariances_euler``: within 1e-3 by norm, all three branches.
- ``close_loop``: poses within 0.05 cm / 1e-4, ELCH frame tags equal;
  the ``device_points`` branch within 1e-3 of the legacy branch (the JAX
  package's own bound); drift shrinks and scan 0 stays.
- ``_quat_mult``, ``_nlerp``: f64 host code, 1e-12.
- ``_edge_covariances_quat``: the port sums the raw moments in f64, the
  JAX package in f32, where Σddᵀ = Paa − Pab − Pabᵀ + Pbb cancels: on
  noise-free scans the JAX residual variance drowns in rounding and most
  of its edges get zero blocks.  So the quaternion tests run on scans
  with 2 cm sensor noise around a centred room: there the JAX blocks are
  within 5e-2 by norm of the port's, and the JAX formulas applied to the
  port's f64 raw sums give the port's blocks within 1e-9.
- ``close_loop_euler`` / ``_quat`` / ``_unitquat`` (-L 1..3): poses
  within 0.05 cm / 1e-4, frame tags equal, on the legacy and the
  resident branch (the quaternion variants on the noisy scans).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_room_cloud
from tpu3dtk.core import math3d as jmath
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.models import elch as jelch
from tpu3dtk.models import graphslam as jgs
from tpu3dtk.models import icp as jicp
from tpu3dtk.models import lum_device as jld
from tpu3dtk_torch import interop
from tpu3dtk_torch.io.frames import AlgoType
from tpu3dtk_torch.models import elch as telch
from tpu3dtk_torch.models import icp as ticp
from tpu3dtk_torch.models import lum_device as tld
from tpu3dtk_torch.utils.metrics import metrics


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The clouds here are small: one intra-op thread is faster than
    eight, and does not fight the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    # tests/test_elch.py:13-32
    "chain": ([(0, 1), (1, 2), (2, 3)], [1.0, 1.0, 1.0], 0, 3, 4, [0.0, 1 / 3, 2 / 3, 1.0]),
    "weighted_chain": ([(0, 1), (1, 2), (2, 3)], [1.0, 2.0, 1.0], 0, 3, 4, [0.0, 0.25, 0.75, 1.0]),
    "branch": ([(0, 1), (1, 2), (2, 3), (1, 4)], [1.0] * 4, 0, 3, 5,
               [0.0, 1 / 3, 2 / 3, 1.0, 1 / 3]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_balancer_cases(case):
    edges, w, first, last, n, want = CASES[case]
    got = telch.graph_balancer(edges, w, first, last, n)
    np.testing.assert_allclose(got, want, atol=1e-12)
    np.testing.assert_allclose(got, jelch.graph_balancer(edges, w, first, last, n), atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_graph_balancer_random_graph_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    edges = [(i, i + 1) for i in range(n - 1)]
    edges += [(int(a), int(b)) for a, b in rng.integers(0, n, (25, 2)) if abs(a - b) > 1]
    w = rng.uniform(0.1, 5.0, len(edges)).tolist()
    first, last = 3, n - 2
    np.testing.assert_allclose(
        telch.graph_balancer(edges, w, first, last, n),
        jelch.graph_balancer(edges, w, first, last, n), atol=1e-12,
    )


def test_python_dijkstra_equals_scipy(rng):
    from scipy.sparse import csr_array
    from scipy.sparse.csgraph import dijkstra

    n = 12
    adj = {i: {} for i in range(n)}
    for a, b in [(i, i + 1) for i in range(n - 2)] + [(0, 5), (2, 9)]:  # vertex 11 unreachable
        adj[a][b] = adj[b][a] = float(rng.uniform(0.5, 2.0))
    rows, cols, vals = zip(*[(u, v, w) for u, nb in adj.items() for v, w in nb.items()])
    D, P = dijkstra(csr_array((vals, (rows, cols)), shape=(n, n)), directed=False,
                    indices=[0, 4], return_predecessors=True)
    tD, tP = telch._all_dijkstra_py(adj, [0, 4], n)
    jD, jP = jelch._all_dijkstra_py(adj, [0, 4], n)
    np.testing.assert_allclose(tD, D, atol=1e-12)
    np.testing.assert_array_equal(tP, P)
    np.testing.assert_array_equal(tP, jP)
    np.testing.assert_array_equal(tD, jD)


def test_host_helpers_equal_jax(rng):
    for _ in range(5):
        q0, q1 = rng.normal(size=4), rng.normal(size=4)
        q0, q1 = q0 / np.linalg.norm(q0), q1 / np.linalg.norm(q1)
        t = float(rng.uniform())
        np.testing.assert_allclose(telch._slerp(q0, q1, t), jelch._slerp(q0, q1, t), atol=1e-12)
    np.testing.assert_allclose(telch._slerp(q0, q0, 0.3), q0, atol=1e-12)
    A = rng.normal(size=(4, 6, 6))
    C = A @ A.transpose(0, 2, 1)
    C[3] = 0.0  # singular: the identity's weights
    np.testing.assert_allclose(
        telch._inv_diag_weights(C, 6), jelch._inv_diag_weights(C, 6), rtol=1e-12)
    assert telch.ELCH_VARIANTS == {
        1: telch.close_loop_euler, 2: telch.close_loop_quat, 3: telch.close_loop_unitquat,
        4: telch.close_loop}
    for _ in range(5):
        a, b = rng.normal(size=4), rng.normal(size=4)
        t = float(rng.uniform())
        np.testing.assert_allclose(telch._quat_mult(a, b), jelch._quat_mult(a, b), atol=1e-12)
        np.testing.assert_allclose(telch._nlerp(a, b, t), jelch._nlerp(a, b, t), atol=1e-12)
    assert set(vars(telch.ElchParams())) == {
        "max_dist_match2", "icp_iterations", "icp_epsilon", "device_points", "corr_cache",
        "device"}
    p = interop.elch_params_from(vars(jelch.ElchParams(max_dist_match2=900.0, icp_iterations=7)))
    assert (p.max_dist_match2, p.icp_iterations, p.icp_epsilon, p.device) == (900.0, 7, 1e-7, "cpu")


def loop_scans(rng, n=8, drift_per_step=2.0, noise=0.0, shift=0.0, n_pts=3000):
    """tests/test_elch.py:35-54: a ring whose odometry has drifted.
    ``noise`` (cm): independent sensor noise per scan; ``shift``: the
    room moved by -shift on every axis (centred on the ring)."""
    world = make_room_cloud(rng, n=n_pts, size=800.0) - shift
    scans, true_poses = [], []
    drift = np.zeros(3)
    for k in range(n):
        ang = 2 * np.pi * k / n
        pos = np.array([200 * np.cos(ang), 0.0, 200 * np.sin(ang)])
        T_true = np.asarray(jmath.euler_to_matrix4(pos, np.zeros(3)))
        true_poses.append(T_true)
        local = np.asarray(jmath.transform3(jmath.m4inv(T_true), world))
        if noise:
            local = local + rng.normal(0, noise, local.shape)
        if k > 0:
            drift = drift + np.array([drift_per_step, 0.0, drift_per_step * 0.5])
        s = TPUScan.from_points(local, f"{k:03d}", pose=np.asarray(
            jmath.euler_to_matrix4(pos + drift, np.zeros(3))))
        s.set_reduction(15.0, 1)
        s.reduced_local()
        scans.append(s)
    return scans, true_poses


def carry(jscans):
    return interop.scans_from_numpy([
        {"identifier": s.identifier, "xyz": s.xyz, "reduced_local": s.reduced_local(),
         "transMatOrg": s.transMatOrg, "transMat": s.transMat}
        for s in jscans
    ])[0]


def resident(jscans, n_slots):
    cap = ((max(len(s.reduced_local()) for s in jscans) + 511) // 512) * 512
    locals_pad, masks = jgs._pad_scan_points(jscans, cap)
    extra = n_slots - len(jscans)
    locals_pad = np.concatenate([locals_pad, np.ones((extra, cap, 3), np.float32)])
    masks = np.concatenate([masks, np.ones((extra, cap), bool)])  # unmasked: n_real must hide them
    mats = np.tile(np.eye(4, dtype=np.float32), (n_slots, 1, 1))
    mats[: len(jscans)] = np.stack([s.transMat for s in jscans])
    return locals_pad, masks, mats


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("first,last,n_real", [(0, 7, 8), (1, 6, 7), (3, 9, 10), (2, 5, 6)])
def test_window_build_equals_jax(rng, first, last, n_real):
    """Window starts clipped to [0, S-W]; scans outside [lo, hi] or >=
    n_real masked out although the resident tensors hold them."""
    jscans, _ = loop_scans(rng)
    locals_pad, masks, mats = resident(jscans, 10)
    args = (first - 2, first + 2, last - 2, last)
    jout = jicp._window_build(
        jnp.asarray(locals_pad), jnp.asarray(masks), jnp.asarray(mats),
        *(jnp.int32(a) for a in args), jnp.int32(n_real), wm=5, wt=3)
    tout = ticp._window_build(_t(locals_pad), _t(masks), _t(mats), *args, n_real, wm=5, wt=3)
    N = masks.shape[1]
    for t, j in zip(tout, jout):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        if j.dtype == bool:
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            np.testing.assert_allclose(t.numpy(), j, atol=1e-3)
    mmask = tout[1].numpy().reshape(5, N)
    s0 = min(max(first - 2, 0), 10 - 5)
    for w in range(5):
        sid = s0 + w
        inside = first - 2 <= sid <= first + 2 and sid < n_real
        assert mmask[w].any() == inside


def test_icp_window_align_matches_jax(rng):
    jscans, _ = loop_scans(rng)
    locals_pad, masks, mats = resident(jscans, 9)
    jres = jicp.icp_window_align(
        jnp.asarray(locals_pad), jnp.asarray(masks), jnp.asarray(mats), 0, 7, 8, 625.0, 1e-7,
        max_iterations=40)
    tres = ticp.icp_window_align(_t(locals_pad), _t(masks), _t(mats), 0, 7, 8, 625.0, 1e-7,
                                 max_iterations=40)
    jT = np.asarray(jres.T)
    assert np.abs(jT[:3, 3]).max() > 5.0  # a real correction
    np.testing.assert_allclose(tres.T.numpy()[:3, 3], jT[:3, 3], atol=0.01)
    np.testing.assert_allclose(tres.T.numpy()[:3, :3], jT[:3, :3], atol=1e-5)
    assert abs(tres.iterations - int(jres.iterations)) <= 3


def test_edge_covariances_match_jax_on_every_branch(rng):
    jscans, _ = loop_scans(rng)
    tscans = carry(jscans)
    edges = [(i, i + 1) for i in range(7)] + [(0, 7)]
    locals_pad, masks, _m = resident(jscans, 8)
    jdp = (jnp.asarray(locals_pad), jnp.asarray(masks))
    tdp = (_t(locals_pad), _t(masks))
    N = masks.shape[1]
    want = jelch._edge_covariances_euler(jscans, edges, jelch.ElchParams())
    branches = {
        "legacy": (jelch.ElchParams(), telch.ElchParams(device="cpu")),
        "device_points": (jelch.ElchParams(device_points=jdp), telch.ElchParams(device_points=tdp)),
        "cached": (
            jelch.ElchParams(device_points=jdp, corr_cache=jld.CorrCache(N)),
            telch.ElchParams(device_points=tdp, corr_cache=tld.CorrCache(N, device="cpu")),
        ),
    }
    for name, (jp, tp) in branches.items():
        for _call in range(2 if name == "cached" else 1):  # the second call reuses every edge
            jC = jelch._edge_covariances_euler(jscans, edges, jp)
            tC = telch._edge_covariances_euler(tscans, edges, tp)
            assert tC.shape == (8, 6, 6) and tC.dtype == np.float64
            for k in range(8):
                assert np.linalg.norm(tC[k] - jC[k]) <= 1e-3 * np.linalg.norm(jC[k]), name
                assert np.linalg.norm(tC[k] - want[k]) <= 1e-3 * np.linalg.norm(want[k]), name
    tc, jc = branches["cached"][1].corr_cache, branches["cached"][0].corr_cache
    assert (tc.n_refresh, tc.n_reuse) == (jc.n_refresh, jc.n_reuse) == (8, 8)


@pytest.mark.parametrize("branch", ["legacy", "device_points", "cached"])
def test_close_loop_matches_jax(rng, branch):
    jscans, true_poses = loop_scans(rng)
    tscans = carry(jscans)
    n = len(jscans)
    edges = [(i, i + 1) for i in range(n - 1)]
    kw = dict(max_dist_match2=2500.0, icp_iterations=80)
    jp, tp = jelch.ElchParams(**kw), interop.elch_params_from(vars(jelch.ElchParams(**kw)))
    if branch != "legacy":
        locals_pad, masks, _m = resident(jscans, n + 2)  # two unmasked slots beyond the prefix
        jp.device_points = (jnp.asarray(locals_pad), jnp.asarray(masks))
        tp.device_points = (_t(locals_pad), _t(masks))
    if branch == "cached":
        jp.corr_cache = jld.CorrCache(masks.shape[1])
        tp.corr_cache = tld.CorrCache(masks.shape[1], device="cpu")

    def drift(scans):
        return np.mean([np.linalg.norm(s.transMat[:3, 3] - T[:3, 3])
                        for s, T in zip(scans, true_poses)])

    before = drift(tscans)
    metrics.reset()
    jelch.close_loop(jscans, 0, n - 1, edges, jp)
    telch.close_loop(tscans, 0, n - 1, edges, tp)
    assert drift(tscans) < before
    np.testing.assert_allclose(tscans[0].transMat, true_poses[0], atol=1e-9)
    assert metrics.counters[telch.ELCH_ICP_ITERATIONS].total >= 3
    for name in (telch.ELCH_COV, telch.ELCH_BALANCE, telch.ELCH_ICP):
        assert metrics.timers[name].count == 1
    for t, j in zip(tscans, jscans):
        np.testing.assert_allclose(t.transMat[:3, 3], j.transMat[:3, 3], atol=0.05)
        np.testing.assert_allclose(t.transMat[:3, :3], j.transMat[:3, :3], atol=1e-4)
        assert [f[1] for f in t.frames] == [f[1] for f in j.frames] == [int(AlgoType.ELCH)]


def test_close_loop_device_points_matches_legacy(rng):
    """tests/test_elch.py::test_close_loop_device_points_matches_legacy
    for the port: the resident-tensor path gives the legacy path's poses."""
    jscans, _ = loop_scans(rng)
    a, b = carry(jscans), carry(jscans)
    n = len(a)
    edges = [(i, i + 1) for i in range(n - 1)]
    telch.close_loop(a, 0, n - 1, edges, telch.ElchParams(device="cpu"))
    locals_pad, masks, _m = resident(jscans, n)
    telch.close_loop(b, 0, n - 1, edges, telch.ElchParams(
        device_points=(_t(locals_pad), _t(masks))))
    for sa, sb in zip(a, b):
        np.testing.assert_allclose(sa.transMat, sb.transMat, atol=1e-3)


def test_edge_covariances_quat_match_jax(rng):
    from tpu3dtk.models import graphslam_variants as jgv
    from tpu3dtk_torch.models import graphslam as tgs
    from tpu3dtk_torch.models import graphslam_variants as tgv

    jscans, _ = loop_scans(rng, noise=2.0, shift=400.0, n_pts=1200)
    tscans = carry(jscans)
    edges = [(i, i + 1) for i in range(7)] + [(0, 7)]
    raw = {k: v.numpy() for k, v in tgv._collect_raw(
        tscans, np.asarray(edges), tgs.LumParams(device="cpu")).items()}
    exact = np.stack([jgv._quat_link_CCD(raw, li)[0] for li in range(8)])
    locals_pad, masks, _m = resident(jscans, 9)
    for jp, tp in (
        (jelch.ElchParams(), telch.ElchParams(device="cpu")),
        (jelch.ElchParams(device_points=(jnp.asarray(locals_pad), jnp.asarray(masks))),
         telch.ElchParams(device_points=(_t(locals_pad), _t(masks)))),
    ):
        jC = jelch._edge_covariances_quat(jscans, edges, jp)
        tC = telch._edge_covariances_quat(tscans, edges, tp)
        assert tC.shape == (8, 7, 7) and tC.dtype == np.float64
        for k in range(8):
            assert np.linalg.norm(jC[k]) > 0
            assert np.linalg.norm(tC[k] - jC[k]) <= 5e-2 * np.linalg.norm(jC[k])
            assert np.linalg.norm(tC[k] - exact[k]) <= 1e-9 * np.linalg.norm(exact[k])


@pytest.mark.parametrize("algo,branch", [
    (1, "legacy"), (1, "device_points"), (2, "device_points"), (3, "legacy"),
])
def test_close_loop_variants_match_jax(rng, algo, branch):
    jscans, true_poses = loop_scans(
        rng, n_pts=1200, **({} if algo == 1 else dict(noise=2.0, shift=400.0)))
    tscans = carry(jscans)
    n = len(jscans)
    edges = [(i, i + 1) for i in range(n - 1)]
    kw = dict(max_dist_match2=2500.0, icp_iterations=80)
    jp, tp = jelch.ElchParams(**kw), interop.elch_params_from(vars(jelch.ElchParams(**kw)))
    if branch == "device_points":
        locals_pad, masks, _m = resident(jscans, n + 2)
        jp.device_points = (jnp.asarray(locals_pad), jnp.asarray(masks))
        tp.device_points = (_t(locals_pad), _t(masks))

    def drift(scans):
        return np.mean([np.linalg.norm(s.transMat[:3, 3] - T[:3, 3])
                        for s, T in zip(scans, true_poses)])

    before = drift(tscans)
    metrics.reset()
    jelch.ELCH_VARIANTS[algo](jscans, 0, n - 1, edges, jp)
    telch.ELCH_VARIANTS[algo](tscans, 0, n - 1, edges, tp)
    assert drift(tscans) < before
    np.testing.assert_allclose(tscans[0].transMat, true_poses[0], atol=1e-9)
    for name in (telch.ELCH_COV, telch.ELCH_BALANCE, telch.ELCH_ICP):
        assert metrics.timers[name].count == 1
    for t, j in zip(tscans, jscans):
        np.testing.assert_allclose(t.transMat[:3, 3], j.transMat[:3, 3], atol=0.05)
        np.testing.assert_allclose(t.transMat[:3, :3], j.transMat[:3, :3], atol=1e-4)
        assert [f[1] for f in t.frames] == [f[1] for f in j.frames] == [int(AlgoType.ELCH)]
