"""The port's offscreen renderer (``ops.render``) against the JAX
package's, on the CPU (``device="cpu"``), on the same seeded clouds.

Bounds: the z-buffer splat at point sizes 1 and 3 gives the JAX
package's image and depth exactly (every pixel, and depth bit for bit
where set: the projection rounds as XLA's fused multiply-adds do), also
where several points tie on depth in one pixel (the largest packed
colour wins in both); ``lod_select`` the same points and weights; the
colour ramps and the camera poses equal."""

import numpy as np
import pytest
import torch

from tests.conftest import make_room_cloud
from tpu3dtk.ops import octree as joct
from tpu3dtk.ops import render as jr
from tpu3dtk_torch.ops import octree as toct
from tpu3dtk_torch.ops import render as tr


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_render(a, b):
    img_a, depth_a = a
    img_b, depth_b = b
    assert img_a.shape == img_b.shape and img_b.dtype == np.uint8
    np.testing.assert_array_equal(img_b, img_a)
    np.testing.assert_array_equal(np.isnan(depth_b), np.isnan(depth_a))
    assert depth_b.dtype == np.float32
    np.testing.assert_array_equal(depth_b[~np.isnan(depth_b)], depth_a[~np.isnan(depth_a)])


@pytest.mark.parametrize("point_size", [1, 3])
@pytest.mark.parametrize("azimuth", [30.0, 215.0])
def test_render_matches_jax(point_size, azimuth):
    rng = np.random.default_rng(7)
    pts = make_room_cloud(rng, n=60000, size=500.0)
    pose = jr.orbit_pose(pts.mean(0), 900.0, azimuth_deg=azimuth)
    kw = dict(width=160, height=120, point_size=point_size)
    a = jr.render_points(pts, pose, **kw)
    b = tr.render_points(pts, pose, device="cpu", **kw)
    _assert_same_render(a, b)
    assert np.isfinite(b[1]).mean() > 0.05
    # a tensor goes through on its own device, with given colours
    colors = rng.integers(0, 256, (len(pts), 3)).astype(np.uint8)
    a = jr.render_points(pts, pose, colors=colors, **kw)
    b = tr.render_points(torch.as_tensor(pts, dtype=torch.float32), pose, colors=colors, **kw)
    _assert_same_render(a, b)


@pytest.mark.parametrize("point_size", [1, 3])
def test_render_depth_ties_match_jax(point_size):
    """Four points a pixel at one depth, each its own colour, in a grid
    whose splats overlap at point size 3: the largest packed colour wins
    every tie, and a nearer point beats all of them."""
    rng = np.random.default_rng(3)
    xs, ys = np.meshgrid(np.arange(-8, 8) * 2.0, np.arange(-6, 6) * 2.0)
    base = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 50.0)], 1)
    pts = np.concatenate([base] * 4 + [base[::7] * [1, 1, 0.5]])
    colors = rng.integers(0, 256, (len(pts), 3)).astype(np.uint8)
    kw = dict(colors=colors, width=64, height=48, fov_deg=60.0, point_size=point_size)
    a = jr.render_points(pts, np.eye(4), **kw)
    b = tr.render_points(pts, np.eye(4), device="cpu", **kw)
    _assert_same_render(a, b)
    assert len(np.unique(b[0].reshape(-1, 3), axis=0)) > 20


def test_render_occlusion_and_projection():
    """tests/test_show.py's case on the port: the near point wins, the
    centred point lands on the image centre, nothing else is drawn."""
    pts = np.array([[0.0, 0.0, 100.0], [0.0, 0.0, 50.0]])
    colors = np.array([[255, 0, 0], [0, 255, 0]], np.uint8)
    img, depth = tr.render_points(pts, np.eye(4), colors=colors, width=64,
                                  height=64, fov_deg=60.0, device="cpu")
    assert tuple(img[32, 32]) == (0, 255, 0)
    assert depth[32, 32] == 50.0
    assert np.isnan(depth).sum() == 64 * 64 - 1


@pytest.mark.parametrize("budget", [2000, 20000])
def test_lod_select_matches_jax(budget):
    rng = np.random.default_rng(42)
    front = rng.uniform(-500, 500, (60_000, 3)) + np.array([0, 0, 3000.0])
    behind = rng.uniform(-500, 500, (60_000, 3)) + np.array([0, 0, -3000.0])
    pts = np.concatenate([front, behind])
    pose = tr.look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    np.testing.assert_array_equal(pose, jr.look_at(np.zeros(3), np.array([0.0, 0.0, 1.0])))
    sj, wj = jr.lod_select(joct.build_octree(pts, 8.0), pose, budget=budget)
    st, wt = tr.lod_select(toct.build_octree(pts, 8.0), pose, budget=budget)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(wt, wj)
    assert 0 < len(st) <= budget and (st[:, 2] > 0).all()


def test_color_modes_and_poses_match_jax():
    rng = np.random.default_rng(42)
    pts = rng.uniform(-100, 300, (500, 3))
    np.testing.assert_array_equal(tr.color_by_height(pts), jr.color_by_height(pts))
    np.testing.assert_array_equal(tr.color_by_height(pts, 0.0, 50.0), jr.color_by_height(pts, 0.0, 50.0))
    v = rng.uniform(0, 1, 300)
    np.testing.assert_array_equal(tr.color_by_value(v), jr.color_by_value(v))
    np.testing.assert_array_equal(tr.color_by_scan([10, 20, 5, 0, 3]), jr.color_by_scan([10, 20, 5, 0, 3]))
    assert tr.color_by_scan([]).shape == (0, 3)
    depth = rng.uniform(10, 90, (24, 32)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.3] = np.nan
    np.testing.assert_array_equal(tr.color_by_depth(depth, 10.0, 90.0), jr.color_by_depth(depth, 10.0, 90.0))
    for az, el in ((0.0, 20.0), (133.0, -10.0), (300.0, 89.9)):
        np.testing.assert_array_equal(
            tr.orbit_pose([1.0, 2.0, 3.0], 500.0, az, el), jr.orbit_pose([1.0, 2.0, 3.0], 500.0, az, el))
    np.testing.assert_array_equal(tr._frustum_planes(1.7, 4 / 3), jr._frustum_planes(1.7, 4 / 3))
