"""The port's cylinder detection (``models.cylinder``) and building model
(``models.building``) against the JAX package's, on the same numpy
inputs, on the CPU (``device="cpu"``).

Bounds: on tests/test_cylinder.py's scenes (0.3 cm radial jitter, so no
two k-NN candidates tie: the port ranks on direct differences) the same
cylinders — axes equal (the same Fibonacci direction wins the vote),
radius within 1e-3 cm, shell inlier counts within 0.1%.  RANSAC draws the
JAX package's ``default_rng(0)`` triples in its order and keeps the first
best.  ``build_model`` on tests/test_aux_modules.py's room: the same wall,
floor and ceiling planes (normals within 1e-9, rho within 1e-6 cm),
the same openings and kinds, extents within one cell.
"""

import numpy as np
import pytest
import torch

from tpu3dtk.models import building as jbld
from tpu3dtk.models import cylinder as jcyl
from tpu3dtk.models.shapes import HoughParams as JHoughParams
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import building as tbld
from tpu3dtk_torch.models import cylinder as tcyl


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cylinder_cloud(rng, axis, center, radius, height, n=3000, noise=0.3):
    """tests/test_cylinder.py's sampler."""
    axis = np.asarray(axis, float)
    axis /= np.linalg.norm(axis)
    u = np.linalg.svd(np.eye(3) - np.outer(axis, axis))[0][:, :2]
    phi = rng.uniform(0, 2 * np.pi, n)
    h = rng.uniform(-height / 2, height / 2, n)
    ring = (radius + rng.normal(0, noise, n))[:, None] * (
        np.cos(phi)[:, None] * u[:, 0] + np.sin(phi)[:, None] * u[:, 1]
    )
    return np.asarray(center) + ring + h[:, None] * axis


def _scenes():
    rng = np.random.default_rng(42)
    single = _cylinder_cloud(rng, [0, 1, 0], [100.0, 0, 50.0], radius=30.0, height=200.0)
    rng = np.random.default_rng(42)
    tilted = _cylinder_cloud(rng, [1.0, 2.0, 0.5], [0.0, 0, 0], radius=20.0, height=150.0)
    rng = np.random.default_rng(8)
    two = np.concatenate([
        _cylinder_cloud(rng, [0, 1, 0], [0.0, 0, 0], 40.0, 250.0, n=2500),
        _cylinder_cloud(rng, [0, 1, 0], [300.0, 0, 100.0], 25.0, 250.0, n=2000),
    ])
    return {"single": (single, {"min_inliers": 500}), "tilted": (tilted, {"min_inliers": 400}),
            "two": (two, {"min_inliers": 300, "max_cylinders": 3})}


@pytest.mark.parametrize("name", ["single", "tilted", "two"])
def test_cylinders_match(name):
    pts, fields = _scenes()[name]
    cj = jcyl.detect_cylinders(pts, params=jcyl.CylinderParams(**fields))
    cp = tcyl.detect_cylinders(pts, params=interop.cylinder_params_from(fields), device="cpu")
    assert len(cj) >= 1 and len(cp) == len(cj)
    for a, b in zip(cp, cj):
        assert np.array_equal(a.axis, b.axis)
        assert abs(a.radius - b.radius) <= 1e-3
        assert abs(a.n_inliers - b.n_inliers) <= 1e-3 * b.n_inliers
        assert np.abs(a.center - b.center).max() < 1e-2


def test_cylinders_with_given_normals_match():
    pts, fields = _scenes()["single"]
    axis = np.array([0.0, 1.0, 0.0])
    radial = pts - np.array([100.0, 0.0, 50.0])
    radial -= np.outer(radial @ axis, axis)
    nrm = radial / np.linalg.norm(radial, axis=1, keepdims=True)
    cj = jcyl.detect_cylinders(pts, nrm, jcyl.CylinderParams(**fields))
    cp = tcyl.detect_cylinders(pts, nrm, interop.cylinder_params_from(fields), device="cpu")
    assert len(cp) == len(cj) >= 1
    for a, b in zip(cp, cj):
        assert np.array_equal(a.axis, b.axis) and a.n_inliers == b.n_inliers
        assert abs(a.radius - b.radius) <= 1e-9


def _room(seed=42, size=600.0, n_face=4000):
    """tests/test_aux_modules.py::test_building_model_openings's room."""
    rng = np.random.default_rng(seed)
    pts = []
    for axis in range(3):
        for side in (0.0, size):
            p = rng.uniform(0, size, (n_face, 3))
            p[:, axis] = side
            if axis == 2 and side == 0.0:
                hole = ((p[:, 0] > 250) & (p[:, 0] < 350) & (p[:, 1] > 150) & (p[:, 1] < 230))
                p = p[~hole]
            pts.append(p)
    return np.concatenate(pts)


def test_build_model_match():
    cloud = _room()
    fields = dict(min_inliers=800, max_planes=8, dist_tol=8.0, n_theta=30, n_phi=60)
    mj = jbld.build_model(cloud, JHoughParams(**fields), cell=10.0)
    mp = tbld.build_model(cloud, interop.hough_params_from(fields), cell=10.0, device="cpu")
    for key in ("walls", "floors", "ceilings", "other"):
        assert len(mp[key]) == len(mj[key]), key
        for a, b in zip(mp[key], mj[key]):
            np.testing.assert_allclose(a.normal, b.normal, atol=1e-9)
            assert abs(a.rho - b.rho) < 1e-6 and a.n_inliers == b.n_inliers
    assert sorted(mp["openings"]) == sorted(mj["openings"]) and mj["openings"]
    for wi, ops in mj["openings"].items():
        assert len(mp["openings"][wi]) == len(ops)
        for a, b in zip(mp["openings"][wi], ops):
            assert a.kind == b.kind
            assert np.abs(a.lo - b.lo).max() <= 10.0 and np.abs(a.hi - b.hi).max() <= 10.0


def test_wall_occupancy_match():
    cloud = _room(seed=3)
    wall = interop.planes_from_numpy([
        {"normal": np.array([0.0, 0.0, 1.0]), "rho": 0.0, "n_inliers": 0, "center": np.zeros(3)}
    ])[0]
    oj, loj, bj = jbld.wall_occupancy(cloud, wall, cell=10.0)
    op, lop, bp = tbld.wall_occupancy(cloud, wall, cell=10.0, device="cpu")
    assert np.array_equal(op, oj) and np.array_equal(lop, loj)
    assert all(np.array_equal(a, b) for a, b in zip(bp, bj))
