"""Semi-rigid registration: the port's ``models.srr`` against the JAX
package's on the line scans of tests/test_srr.py::_make_linescans (a
room seen from L poses along a line, 1500 points a line, linear lateral
odometry drift), each package starting from the same state
(``interop.line_scan_set_from_numpy``).

Bounds: ``linear_distribute_error`` is host f64 in both packages, so
poses agree within 1e-9; ``pre_registration`` (one ICP, K1's plain
version here) and ``semi_rigid_registration`` (window covariances
through K1's plain version, the same scipy solve) within 0.5 cm
translation and 1e-3 on rotation entries (the port's sequence tests'
bound), with the same frames tags.  The semi-rigid test starts both
packages from the JAX package's pre-registered state, so it holds the
relaxation alone."""

import numpy as np
import pytest
import torch

from tpu3dtk.models import srr as jsrr
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import srr as tsrr
from tpu3dtk_torch.utils.metrics import metrics
from tests.test_srr import _err, _make_linescans


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(ls):
    return interop.line_scan_set_from_numpy(
        {k: getattr(ls, k) for k in ("points", "masks", "poses", "poses_org", "frames")}
    )


def _pair(L):
    ls, true_poses = _make_linescans(np.random.default_rng(42), L=L)
    return ls, _carry(ls), true_poses


def _assert_close(t, j):
    np.testing.assert_allclose(t.poses[:, :3, 3], j.poses[:, :3, 3], atol=0.5)
    np.testing.assert_allclose(t.poses[:, :3, :3], j.poses[:, :3, :3], atol=1e-3)
    assert [a for _m, a in t.frames] == [a for _m, a in j.frames]


def test_linear_distribute_error_matches_jax():
    j, t, true_poses = _pair(20)
    jsrr.linear_distribute_error(j, 0, 19, true_poses[19])
    tsrr.linear_distribute_error(t, 0, 19, true_poses[19])
    np.testing.assert_allclose(t.poses, j.poses, rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.poses[19], true_poses[19], atol=1e-9)
    # and a correction with a rotation, over an inner span
    T = true_poses[12].copy()
    T[:3, :3] = np.asarray(jsrr.math3d.euler_to_matrix4([0, 0, 0], [0.02, -0.01, 0.03]))[:3, :3]
    jsrr.linear_distribute_error(j, 4, 12, T)
    tsrr.linear_distribute_error(t, 4, 12, T)
    np.testing.assert_allclose(t.poses, j.poses, rtol=0, atol=1e-9)


def test_pre_registration_matches_jax():
    j, t, true_poses = _pair(40)
    before = _err(j, true_poses)
    kw = dict(first=(0, 6), last=(33, 39), max_dist_match2=2500.0, max_iterations=80)
    jsrr.pre_registration(j, **kw)
    iters = tsrr.pre_registration(t, device="cpu", **kw)
    assert iters > 0
    _assert_close(t, j)
    assert _err(t, true_poses) < 0.5 * before


def test_semi_rigid_registration_matches_jax():
    """Both packages relax from the JAX package's pre-registered state
    (tests/test_srr.py::test_semi_rigid_registration's run)."""
    j, _t, true_poses = _pair(30)
    before = _err(j, true_poses)
    jsrr.pre_registration(j, first=(0, 6), last=(23, 29),
                          max_dist_match2=2500.0, max_iterations=80)
    t = _carry(j)
    p = jsrr.SrrParams(scaninterval=5, scansize=4, iterations=2,
                       lum_max_dist2=2500.0, odom_weight=5.0)
    metrics.reset()
    jret = jsrr.semi_rigid_registration(j, p)
    tret = tsrr.semi_rigid_registration(t, interop.srr_params_from(vars(p)), device="cpu")
    _assert_close(t, j)
    # the mean position correction of the last iteration (cm); the port's
    # f32 link sums round in another order, ~0.01 cm apart here
    assert abs(tret - jret) < 0.05
    # 7 windows (representatives 0, 5, ..., 25, 29): 6 consecutive links
    # and 6 proximity links, once for each of the 2 iterations
    assert metrics.counters[tsrr.SRR_LINK_CALLS].total == 24
    assert _err(t, true_poses) < 0.5 * before
    np.testing.assert_array_equal(t.poses[0], t.poses_org[0])
