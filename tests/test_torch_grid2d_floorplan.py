"""The port's occupancy grids (``models.grid2d``), probabilistic Hough
lines (``ops.lines``) and floor plans (``models.floorplan``) against the
JAX package's and OpenCV's, on the same numpy inputs, on the CPU
(``device="cpu"``).

Bounds: ``hits`` / ``visits`` identical, also with a ray tile of a few
hundred samples (int32 scatter-adds are exact in any order); the pgm,
gnuplot and world files byte-identical; ``extract_gridlines`` segments
equal; ``hough_lines_p`` equal to ``cv2.HoughLinesP`` (the same random
point order, f32 votes and fixed-point walk); ``extract_floorplan``
equal to the JAX package's and meeting tests/test_floorplan.py's
criteria.
"""

import cv2
import numpy as np
import pytest
import torch

from tpu3dtk.models import floorplan as jfp
from tpu3dtk.models import grid2d as jg
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import floorplan as tfp
from tpu3dtk_torch.models import grid2d as tg
from tpu3dtk_torch.ops.lines import hough_lines_p


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scans(seed=3):
    """Two scans (f64 and f32 points) of walls and clutter, origins off
    the cell centres."""
    rng = np.random.default_rng(seed)
    n = 700
    a = np.stack([rng.uniform(-1000, 1000, n), rng.normal(0, 50, n), rng.uniform(-800, 900, n)], 1)
    b = np.stack([rng.uniform(-500, 1500, n), rng.normal(80, 40, n),
                  np.full(n, 700.0) + rng.normal(0, 2, n)], 1).astype(np.float32)
    return [a, b], [np.array([3.3, 1.0, -7.7]), np.array([100.1, 0.0, 50.3], np.float32)]


@pytest.mark.parametrize("fields", [
    {"resolution": 7.0}, {"resolution": 20.0, "y_min": 0.0, "y_max": 100.0, "count_free": False},
])
def test_occupancy_counts_identical(fields):
    pts, orgs = _scans()
    gj = jg.make_occupancy_grid(pts, orgs, jg.Grid2DParams(**fields))
    for tile in (None, 333):
        gp = tg.make_occupancy_grid(pts, orgs, interop.grid2d_params_from(fields), device="cpu",
                                    tile_samples=tile)
        assert np.array_equal(gp.hits, gj.hits) and np.array_equal(gp.visits, gj.visits)
        assert gp.hits.dtype == np.int32 and np.array_equal(gp.origin, gj.origin)


def test_grid_writers_byte_identical(tmp_path):
    pts, orgs = _scans(5)
    gj = jg.make_occupancy_grid(pts, orgs, jg.Grid2DParams(resolution=20.0))
    gp = interop.occupancy_grid_from_numpy(vars(gj))
    gj.write_pgm(str(tmp_path / "j.pgm"))
    gp.write_pgm(str(tmp_path / "p.pgm"))
    assert jg.write_gnuplot(gj, str(tmp_path / "j.dat")) == tg.write_gnuplot(gp, str(tmp_path / "p.dat"))
    jg.write_world(gj, str(tmp_path / "j.w"))
    tg.write_world(gp, str(tmp_path / "p.w"))
    for ext in ("pgm", "dat", "w"):
        assert (tmp_path / f"j.{ext}").read_bytes() == (tmp_path / f"p.{ext}").read_bytes()


@pytest.mark.parametrize("seed", [3])
def test_gridlines_equal(seed):
    pts, orgs = _scans(seed)
    gj = jg.make_occupancy_grid(pts, orgs, jg.Grid2DParams(resolution=10.0))
    sj = jg.extract_gridlines(gj, min_votes=5, min_length=3.0)
    sp = tg.extract_gridlines(interop.occupancy_grid_from_numpy(vars(gj)), min_votes=5,
                              min_length=3.0, device="cpu")
    assert len(sp) == len(sj) > 5
    for (a0, a1), (b0, b1) in zip(sp, sj):
        assert np.array_equal(a0, b0) and np.array_equal(a1, b1)


def _room_image():
    """tests/test_floorplan.py's room as the floor plan's hits image."""
    rng = np.random.default_rng(42)
    g = jg.make_occupancy_grid([_room_cloud(rng)], [np.array([300.0, 100.0, 300.0])],
                               jg.Grid2DParams(resolution=10.0, y_min=50.0, y_max=200.0,
                                               count_free=False))
    return (g.hits > 0).astype(np.uint8) * 255


def _room_cloud(rng):
    pts = []
    n = 4000
    for axis, off in [(0, 0.0), (0, 600.0), (2, 0.0), (2, 600.0)]:
        w = np.zeros((n, 3))
        w[:, 0 if axis == 2 else 2] = rng.uniform(0, 600, n)
        w[:, axis] = off + rng.normal(0, 2.0, n)
        w[:, 1] = rng.uniform(60, 180, n)
        pts.append(w)
    return np.concatenate(pts)


def _seeded_image(seed, H=180, W=240):
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W), np.uint8)
    for _ in range(10):
        p = rng.uniform([0, 0], [W, H], (2, 2)).astype(int)
        cv2.line(img, (int(p[0, 0]), int(p[0, 1])), (int(p[1, 0]), int(p[1, 1])), 255, 1)
    img[rng.uniform(size=img.shape) < 0.01] = 255
    img[rng.uniform(size=img.shape) < 0.05] = 0
    return img


@pytest.mark.parametrize("image,args", [
    ("room", (1, np.pi / 180, 15, 20, 5)),
    ("seed11", (1, np.pi / 180, 12, 8, 3)),
    ("seed12", (2, np.pi / 90, 10, 5, 2)),
])
def test_hough_lines_p_equals_opencv(image, args):
    img = _room_image() if image == "room" else _seeded_image(int(image[4:]))
    rho, theta, thr, length, gap = args
    ref = cv2.HoughLinesP(img, rho, theta, thr, minLineLength=length, maxLineGap=gap)
    ref = np.zeros((0, 4), np.int32) if ref is None else np.asarray(ref).reshape(-1, 4)
    got = hough_lines_p(img, rho, theta, thr, length, gap)
    assert got.dtype == np.int32 and len(ref) > 3
    assert np.array_equal(got, ref)


def test_extract_floorplan_matches():
    """tests/test_floorplan.py's room and criteria."""
    rng = np.random.default_rng(42)
    cloud = _room_cloud(rng)
    fields = dict(resolution=10.0, min_votes=15, min_length=200.0)
    org = [np.array([300.0, 100.0, 300.0])]
    sj = jfp.extract_floorplan([cloud], org, jfp.FloorplanParams(**fields))
    sp = tfp.extract_floorplan([cloud], org, interop.floorplan_params_from(fields), device="cpu")
    assert len(sp) == len(sj)
    for a, b in zip(sp, sj):
        assert np.array_equal(a.p0, b.p0) and np.array_equal(a.p1, b.p1)
    assert len(sp) >= 4
    assert sorted(s.length for s in sp)[-1] > 400.0
    dirs = np.asarray([np.abs((s.p1 - s.p0) / (np.linalg.norm(s.p1 - s.p0) + 1e-9)) for s in sp])
    assert (dirs.max(1) > 0.97).mean() > 0.7
