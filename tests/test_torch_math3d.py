"""The port's math3d (numpy and torch backends) against the JAX package's
(jnp backend) on the same f64 inputs, every conversion including the
gimbal-lock branch of Matrix4ToEuler and all four Shepperd branches of
Matrix4ToQuat.  Tolerance 1e-12: the formulas are the same, only libm
and summation order differ at f64 rounding."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu3dtk.core import math3d as jm
from tpu3dtk_torch.core import math3d as tm

TOL = 1e-12


def _quats():
    q = np.asarray([
        [1.0, 0.1, -0.2, 0.1],   # w dominant
        [0.1, 1.0, 0.2, -0.1],   # x dominant
        [-0.2, 0.1, 1.0, 0.3],   # y dominant
        [0.1, -0.3, 0.2, 1.0],   # z dominant
    ])
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _thetas():
    return np.asarray([
        [0.1, -0.4, 0.7],
        [2.5, 1.2, -2.9],
        [0.3, np.pi / 2, 0.2],      # gimbal: cos(theta_y) = 0
        [-0.6, -np.pi / 2, 1.1],    # gimbal, other sign
        [0.2, np.pi / 2 - 1e-3, -0.4],  # |cos| <= 0.005: gimbal branch
        [0.0, 3.0, 0.5],            # a0 < 0: the pi - asin branch
    ])


def _mats():
    pos = np.asarray([[10.0, -20.0, 30.0]] * len(_thetas()))
    return np.asarray(jm.euler_to_matrix4(pos, _thetas(), xp=np))


CASES = {
    "euler_to_matrix3": (lambda m, a: m.euler_to_matrix3(a[0]), lambda: (_thetas(),)),
    "euler_to_matrix4": (
        lambda m, a: m.euler_to_matrix4(a[0], a[1]),
        lambda: (np.asarray([[1.0, 2.0, 3.0]] * 6), _thetas()),
    ),
    "matrix4_to_euler": (lambda m, a: m.matrix4_to_euler(a[0]), lambda: (_mats(),)),
    "matrix4_to_quat": (
        lambda m, a: m.matrix4_to_quat(a[0]),
        lambda: (np.asarray(jm.quat_to_matrix4(_quats(), xp=np)),),
    ),
    "quat_to_matrix3": (lambda m, a: m.quat_to_matrix3(a[0]), lambda: (_quats(),)),
    "quat_to_matrix4": (
        lambda m, a: m.quat_to_matrix4(a[0], a[1]),
        lambda: (_quats(), np.asarray([[5.0, 6.0, 7.0]] * 4)),
    ),
    "from_colmajor16": (
        lambda m, a: m.from_colmajor16(a[0]),
        lambda: (np.arange(32.0).reshape(2, 16),),
    ),
    "to_colmajor16": (lambda m, a: m.to_colmajor16(a[0]), lambda: (_mats(),)),
    "m4inv": (lambda m, a: m.m4inv(a[0]), lambda: (_mats(),)),
    "transform3": (
        lambda m, a: m.transform3(a[0], a[1]),
        lambda: (_mats()[1], np.random.default_rng(0).normal(0, 100, (50, 3))),
    ),
    "transform3normal": (
        lambda m, a: m.transform3normal(a[0], a[1]),
        lambda: (_mats()[0], np.random.default_rng(1).normal(0, 1, (20, 3))),
    ),
    "pose_to_matrix": (
        lambda m, a: m.pose_to_matrix(a[0], a[1]),
        lambda: (np.asarray([1.0, 2.0, 3.0]), np.asarray([10.0, -80.0, 170.0])),
    ),
    "matrix_to_pose": (lambda m, a: m.matrix_to_pose(a[0]), lambda: (_mats(),)),
    "rad": (lambda m, a: m.rad(a[0]), lambda: (np.asarray([0.0, 90.0, -45.0]),)),
    "deg": (lambda m, a: m.deg(a[0]), lambda: (np.asarray([0.0, 1.0, -0.5]),)),
}


def _flat(out):
    if isinstance(out, tuple):
        return [_flat(o)[0] for o in out]
    if isinstance(out, torch.Tensor):
        return [out.cpu().numpy()]
    return [np.asarray(out)]


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_math3d_matches_jax(name, backend):
    fn, make = CASES[name]
    args = make()
    want = _flat(fn(jm, [jnp.asarray(a) for a in args]))
    if backend == "torch":
        got_raw = fn(tm, [torch.as_tensor(a) for a in args])
        for g in (got_raw if isinstance(got_raw, tuple) else (got_raw,)):
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float64
    else:
        got_raw = fn(tm, args)
    got = _flat(got_raw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


def test_gimbal_branch_is_taken():
    theta, _ = tm.matrix4_to_euler(torch.as_tensor(_mats()))
    # the gimbal rows report theta_x = 0 and fold the roll into theta_z
    assert theta[2, 0] == 0 and theta[3, 0] == 0 and theta[4, 0] == 0
    assert theta[0, 0] != 0


def test_pose_roundtrip_torch_on_device_of_input():
    T = torch.as_tensor(_mats()[:2])
    pos, th = tm.matrix_to_pose(T)
    back = tm.pose_to_matrix(pos, th)
    np.testing.assert_allclose(back.numpy(), _mats()[:2], atol=1e-12)
    assert back.device == T.device
