"""The plain reference against straightforward f64 numpy at a tiny size:
nearest neighbours, the voxel reduction, ICP, the LUM link statistics and
iteration, the ELCH balancer, and the replay of frames into steps."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slambench.reference import events, plain
from slambench.reference import math3d as m3

DEV = "cpu"


def _cloud(seed, n=3000):
    """Points on three faces of a 400 cm box corner, with noise."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 400, (n, 3))
    p[np.arange(n) % 3 == 0, 0] = 0.0
    p[np.arange(n) % 3 == 1, 1] = 0.0
    p[np.arange(n) % 3 == 2, 2] = 0.0
    return p + rng.normal(0, 0.5, p.shape)


def _pose(yaw, t):
    return m3.euler_to_matrix4(np.asarray(t, float), np.array([0.01, yaw, -0.02]))


def test_nearest_equals_numpy_brute():
    rng = np.random.default_rng(1)
    m, q = rng.uniform(0, 300, (700, 3)), rng.uniform(-20, 320, (500, 3))
    idx, ok = plain.nearest(torch.as_tensor(q), torch.as_tensor(m), 30.0**2)
    d2 = ((q[:, None] - m[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx.numpy()[ok.numpy()], d2.argmin(1)[ok.numpy()])
    np.testing.assert_array_equal(ok.numpy(), d2.min(1) < 30.0**2)


def test_reduce_keeps_the_first_point_of_each_voxel_in_voxel_order():
    xyz = (_cloud(2, 4000) * 0.3).astype(np.float32)
    got = plain.reduce_scan(xyz, 10.0, 1, seed=0)
    perm = torch.randperm(len(xyz), generator=torch.Generator().manual_seed(0)).numpy()
    p = xyz[perm]
    origin = p.min(0)
    first = {}
    for pt in p:
        key = tuple(np.floor((pt - origin) / np.float32(10.0)).astype(np.int64))
        first.setdefault(key, pt)
    want = np.stack([first[k] for k in sorted(first)])
    np.testing.assert_array_equal(got, want)


def _icp_numpy(model, target, T0, max_d2, eps, iters):
    """Arun's SVD point-to-point ICP in f64 numpy with the same stops."""
    T, ret, prev = T0.copy(), 0.0, 0.0
    for _ in range(iters):
        tg = target @ T[:3, :3].T + T[:3, 3]
        d2 = ((tg[:, None] - model[None]) ** 2).sum(-1)
        j, ok = d2.argmin(1), d2.min(1) < max_d2
        mm, dd = model[j][ok], tg[ok]
        cm, cd = mm.mean(0), dd.mean(0)
        U, _, Vt = np.linalg.svd((dd - cd).T @ (mm - cm))
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ D @ U.T
        align = np.eye(4)
        align[:3, :3], align[:3, 3] = R, cm - R @ cd
        err = np.sqrt(((mm - dd) ** 2).sum(1).mean())
        T = align @ T
        prev2, prev, ret = prev, ret, err
        if (abs(ret - prev) < eps and abs(ret - prev2) < eps) or (
                np.linalg.norm(align[:3, 3]) < 1e-2 and np.linalg.norm(R - np.eye(3)) < 1e-5):
            break
    return T


def test_icp_recovers_the_pose_as_numpy_svd_does():
    local = _cloud(3, 1500)
    truth = _pose(0.02, [3.0, -2.0, 4.0])
    model = local @ truth[:3, :3].T + truth[:3, 3]
    T0 = _pose(0.0, [0.0, 0.0, 0.0])
    T, it = plain.icp(model, local, T0, 50.0**2, 1e-9, 60, plain.REFERENCE, DEV)
    Tn = _icp_numpy(model, local, T0, 50.0**2, 1e-9, 60)
    lo, hi = local.min(0), local.max(0)
    assert m3.box_gap(T, truth, lo, hi) < 0.05 and m3.box_gap(T, Tn, lo, hi) < 1e-4
    assert 1 < it < 60


def _link_numpy(a, b):
    """lum6Deuler.cc's covariance of a link from its pairs a (scan i), b (scan j)."""
    mid, d = (a + b) / 2, a - b
    x, y, z = mid.T
    M = np.zeros((len(a), 3, 6))
    M[:, 0, 0] = M[:, 1, 1] = M[:, 2, 2] = 1.0
    M[:, 0, 4], M[:, 0, 5] = -y, z
    M[:, 1, 3], M[:, 1, 4] = -z, x
    M[:, 2, 3], M[:, 2, 5] = y, -x
    MM = np.einsum("nki,nkj->ij", M, M)
    MZ = np.einsum("nki,nk->i", M, d)
    D = np.linalg.solve(MM, MZ)
    r = d - np.einsum("nki,i->nk", M, D)
    ss = (r * r).sum() / (2 * len(a) - 3)
    return MM / ss, MZ / ss


def test_link_statistics_equal_the_numpy_formula():
    a = _cloud(4, 800)
    b = a + np.random.default_rng(5).normal(0, 0.3, a.shape) + [0.4, -0.2, 0.1]
    C, CD = plain.link_cov(torch.as_tensor(a), torch.as_tensor(b), 25.0**2)
    j = ((b[:, None] - a[None]) ** 2).sum(-1).argmin(1)  # b's nearest in a
    Cn, CDn = _link_numpy(a[j], b)
    np.testing.assert_allclose(C, Cn, rtol=1e-9)
    np.testing.assert_allclose(CD, CDn, rtol=1e-9, atol=1e-9 * np.abs(CDn).max())


def test_lum_iteration_pulls_a_displaced_scan_back():
    pts = [_cloud(6, 1500), _cloud(60, 1500)]  # two samplings of one box corner
    mats = np.stack([_pose(0.1, [10.0, 0.0, 5.0]), _pose(0.1, [10.0, 0.0, 5.0])])
    exact = plain.lum_iteration(pts, mats, [(0, 1)], 50.0**2, plain.REFERENCE, DEV)
    lo, hi = pts[1].min(0), pts[1].max(0)
    assert m3.box_gap(exact[1], mats[1], lo, hi) < 1.0  # point-to-point on two samplings
    moved = mats.copy()
    moved[1] = _pose(0.1, [14.0, 2.0, 5.0])
    new = plain.lum_iteration(pts, moved, [(0, 1)], 50.0**2, plain.REFERENCE, DEV)
    assert m3.box_gap(new[1], mats[1], lo, hi) < 0.85 * m3.box_gap(moved[1], mats[1], lo, hi)


def _three_scans():
    pts = [_cloud(6, 1200), _cloud(60, 1200), _cloud(61, 1200)]  # three samplings of one box corner
    mats = np.stack([_pose(0.1, [10.0, 0.0, 5.0]), _pose(0.12, [13.0, 1.0, 5.0]), _pose(0.08, [8.0, -2.0, 6.0])])
    return pts, mats, [(0, 1), (1, 2), (0, 2)]


def test_lum_relax_repeats_the_iteration_until_the_shift_is_small():
    pts, mats, links = _three_scans()
    poses, rets = plain.lum_relax(pts, mats, links, 50.0**2, 4, 0.0, plain.REFERENCE, DEV, carry_euler=False)
    assert len(poses) == len(rets) == 4
    want = mats
    for got in poses:  # each iteration from the poses the last one set
        want = plain.lum_iteration(pts, want, links, 50.0**2, plain.REFERENCE, DEV)
        np.testing.assert_allclose(got, want, atol=1e-9)
    assert rets[-1] < rets[0]
    stop = rets[1] * 1.01  # the second iteration's shift is below epsilon: two iterations
    poses2, rets2 = plain.lum_relax(pts, mats, links, 50.0**2, 4, stop, plain.REFERENCE, DEV, carry_euler=False)
    assert len(poses2) == 2 and rets2 == rets[:2]
    poses3, _ = plain.lum_relax(pts, mats, links, 50.0**2, 4, stop, plain.REFERENCE, DEV, carry_euler=False,
                                at_least=3)
    assert len(poses3) == 3


def test_carried_euler_state_matters_only_at_a_quarter_turn():
    pts, mats, links = _three_scans()
    a, _ = plain.lum_relax(pts, mats, links, 50.0**2, 3, 0.0, plain.REFERENCE, DEV, carry_euler=True)
    b, _ = plain.lum_relax(pts, mats, links, 50.0**2, 3, 0.0, plain.REFERENCE, DEV, carry_euler=False)
    np.testing.assert_allclose(a[-1], b[-1], atol=1e-9)
    turned = mats.copy()
    turned[1] = m3.euler_to_matrix4(turned[1][:3, 3], np.array([0.3, np.pi / 2 - 0.003, 0.2]))  # the gimbal branch
    theta, pos = m3.matrix4_to_euler(turned[1])
    assert not np.allclose(m3.euler_to_matrix4(pos, theta), turned[1], atol=1e-6)
    a, _ = plain.lum_relax(pts, turned, links, 50.0**2, 1, 0.0, plain.REFERENCE, DEV, carry_euler=True)
    b, _ = plain.lum_relax(pts, turned, links, 50.0**2, 1, 0.0, plain.REFERENCE, DEV, carry_euler=False)
    assert not np.allclose(a[0][1], b[0][1], atol=1e-6)


@pytest.mark.parametrize("k_got,rets,want", [
    (3, [2.0, 0.5, 0.09], 3),  # the same stop
    (4, [2.0, 0.5, 0.095, 0.08], 4),  # the third shift within STOP_TOL of epsilon: either stop
    (10, [2.0, 0.5, 0.09, 0.05] + [0.01] * 6, 3),  # ran on past a clear stop
    (1, [2.0, 0.5, 0.09], 3),  # stopped while the reference still moved
    (5, [2.0, 1.0, 0.8, 0.6, 0.4], 5),  # ran out of iterations on both sides
])
def test_a_relaxation_is_compared_at_a_stop_the_reference_allows(k_got, rets, want):
    from slambench.reference import check

    assert check._stop_at(k_got, rets, 5 if want == 5 else 10, 0.1) == want


def test_balancer_interpolates_along_a_loop_by_path_length():
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4)]
    w = plain.graph_balancer(edges, [1.0, 1.0, 2.0, 1.0, 1.0], 0, 4, 5)
    np.testing.assert_allclose(w, [0.0, 0.2, 0.4, 0.8, 1.0])


def test_elch_leaves_a_consistent_loop_alone():
    world = _cloud(7, 1500)
    mats = np.stack([_pose(0.05 * k, [30.0 * k, 0.0, 0.0]) for k in range(8)])
    locals_ = [(world - T[:3, 3]) @ T[:3, :3] for T in mats]  # the world seen from each pose
    edges = [(k, k + 1) for k in range(7)]
    new = plain.elch_slerp(locals_, mats, 2, 7, edges, 50.0**2, 1e-9, 30, plain.REFERENCE, DEV)
    lo, hi = world.min(0) - 300, world.max(0) + 300
    assert max(m3.box_gap(a, b, lo, hi) for a, b in zip(new, mats)) < 0.05


def test_replay_reads_steps_from_frames():
    I = np.eye(4)

    def T(x):
        out = I.copy()
        out[0, 3] = x
        return out

    E, L, A, V, P = events.ELCH, events.LUM, events.ICPINACTIVE, events.INVALID, events.ICP
    frames = [
        [(T(0), A), (T(0), A), (T(0), E), (T(0), L)],
        [(T(1), P), (T(1), A), (T(1.5), E), (T(1.4), L)],
        [(T(2), V), (T(2.2), P), (T(2.1), E), (T(2.0), L)],
        [(T(3), V), (T(3), V)],
    ]
    steps = events.replay(frames, [T(0), T(1.1), T(2.3), T(3)])
    assert [s.kind for s in steps] == ["match", "match", "elch", "lum"]
    assert steps[0].target == 1 and steps[1].target == 2
    assert steps[2].participants == [0, 1, 2] and steps[3].run_start
    assert steps[1].before[1][0, 3] == 1.0 and steps[1].before[2][0, 3] == 2.0
    assert steps[3].before[1][0, 3] == 1.5 and steps[3].after[1][0, 3] == 1.4


@pytest.mark.parametrize("x", [1.0, 1000.125, -2400.7])
def test_tf32_keeps_ten_mantissa_bits(x):
    got = float(plain.to_tf32(torch.tensor([x]))[0])
    assert abs(got - x) <= abs(x) * 2.0**-11 and got != x or x == 1.0
