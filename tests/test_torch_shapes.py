"""Plane detection of the port (``models.shapes``, ``io.hough_config``,
``torchplanes``) against the JAX package's, on the same numpy inputs.

Bounds:
- ``hough_accumulator``: the same total; at most 1e-4 of the votes in
  another cell (f32 rho in another summation order may cross a bin
  edge).  The tiled vote equals the one-tile vote exactly.
- ``detect_planes`` (SHT) and ``detect_planes_rht`` on the JAX tests'
  inputs (tests/test_shapes.py): the same number of planes, normals
  within 0.01°, rho within 0.01 cm, inliers within 0.5%.
- ``hough_config``: identical dicts and HoughParams.
- ``torchplanes --device cpu`` against ``tpuplanes`` (no reduction): the
  same plane files within the bounds above.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.conftest import make_room_cloud
from tpu3dtk.cli import planes as jplanes_cli
from tpu3dtk.io import hough_config as jcfg
from tpu3dtk.models import shapes as jshapes
from tpu3dtk_torch import interop
from tpu3dtk_torch.cli import planes as tplanes_cli
from tpu3dtk_torch.io import hough_config as tcfg
from tpu3dtk_torch.models import shapes as tshapes


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _single_plane(rng):
    pts = rng.uniform(0, 500, (2000, 3))
    pts[:, 1] = 100.0 + rng.normal(0, 0.5, 2000)
    return pts, dict(min_inliers=200, dist_tol=5.0, rho_max=1000.0)


def _three_walls(rng):
    walls = []
    for axis, off in [(0, 0.0), (1, 0.0), (2, 300.0)]:
        w = rng.uniform(0, 300, (1500, 3))
        w[:, axis] = off + rng.normal(0, 0.3, 1500)
        walls.append(w)
    return np.concatenate(walls), dict(min_inliers=400, dist_tol=5.0, rho_max=600.0)


def _noise_only(rng):
    return rng.uniform(0, 500, (1000, 3)), dict(min_inliers=400, dist_tol=3.0, rho_max=1000.0)


def _room(rng):
    return make_room_cloud(rng, n=6000, size=700.0), dict(min_inliers=400, max_planes=8, dist_tol=8.0)


def assert_planes_match(tp, jp):
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        ang = np.degrees(np.arccos(np.clip(np.dot(a.normal, b.normal), -1.0, 1.0)))
        assert ang <= 0.01, (a, b)
        assert abs(a.rho - b.rho) <= 0.01, (a, b)
        assert abs(a.n_inliers - b.n_inliers) <= 0.005 * b.n_inliers, (a, b)
        np.testing.assert_allclose(a.center, b.center, atol=0.01)


@pytest.mark.parametrize("make", [_single_plane, _three_walls])
def test_hough_accumulator_matches_jax(make, monkeypatch):
    pts, hp = make(np.random.default_rng(42))
    ja, jd, jw = jshapes.hough_accumulator(pts.astype(np.float32), jshapes.HoughParams(**hp))
    ta, td, tw = tshapes.hough_accumulator(pts, tshapes.HoughParams(**hp), device="cpu")
    assert ta.shape == ja.shape and ta.dtype == np.int32
    np.testing.assert_array_equal(td, jd)
    assert tw == jw
    assert ta.sum() == ja.sum() == len(pts) * len(td)
    moved = np.abs(ta.astype(np.int64) - ja).sum() // 2
    assert moved <= 1e-4 * ja.sum(), moved
    # tiles of 7 points vote the same counts as the tiles of the default size
    monkeypatch.setattr(tshapes, "_CPU_TILE_ELEMS", 7 * len(td))
    small, _, _ = tshapes.hough_accumulator(pts, tshapes.HoughParams(**hp), device="cpu")
    np.testing.assert_array_equal(small, ta)


@pytest.mark.parametrize("make", [_single_plane, _three_walls, _noise_only])
def test_detect_planes_matches_jax(make):
    pts, hp = make(np.random.default_rng(42))
    jp = jshapes.detect_planes(pts, jshapes.HoughParams(**hp))
    tp = tshapes.detect_planes(pts, tshapes.HoughParams(**hp), device="cpu")
    assert_planes_match(tp, jp)
    if make is _noise_only:
        assert tp == []
    else:
        assert len(tp) == (1 if make is _single_plane else 3)


def test_detect_planes_rht_matches_jax():
    pts, hp = _room(np.random.default_rng(42))
    jp = jshapes.detect_planes_rht(pts, jshapes.HoughParams(**hp), seed=3)
    tp = tshapes.detect_planes_rht(pts, tshapes.HoughParams(**hp), seed=3, device="cpu")
    assert len(tp) >= 4
    assert_planes_match(tp, jp)
    # the interop carries a JAX plane list across unchanged
    carried = interop.planes_from_numpy([vars(p) for p in jp])
    assert_planes_match(carried, jp)


def test_hough_config_matches_jax(tmp_path):
    cfg = tmp_path / "hough.cfg"
    cfg.write_text(
        "# comment-ish noise\nMaxPointPlaneDist 5.0\nMaxPlanes 7\nMinSizeAllPoints 33\n"
        "RhoNum 250\nRhoMax 900\nThetaNum 2\nPeakWindow yes\nPlaneDir out/\nSomethingUnknown 42\n"
    )
    assert tcfg.HOUGH_DEFAULTS == jcfg.HOUGH_DEFAULTS
    tc, jc = tcfg.load_hough_config(str(cfg)), jcfg.load_hough_config(str(cfg))
    assert tc == jc
    assert [type(v) for v in tc.values()] == [type(v) for v in jc.values()]
    tp, jp = tcfg.hough_params_from_config(tc), jcfg.hough_params_from_config(jc)
    assert isinstance(tp, tshapes.HoughParams) and tp.n_theta == 1
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert interop.hough_params_from(vars(jp)) == tp


def _read_planes(out):
    planes = []
    for path in (out / "planes.list").read_text().split():
        lines = open(path).read().split("\n")
        planes.append(tshapes.Plane(
            normal=np.array(lines[0].split(), float), rho=float(lines[1]),
            center=np.array(lines[2].split(), float), n_inliers=int(lines[3]),
        ))
    return planes


@pytest.mark.parametrize("algo", ["sht", "rht"])
def test_planes_cli_matches_jax(tmp_path, algo):
    rng = np.random.default_rng(4)
    n = 3000
    a = np.stack([rng.uniform(0, 500, n), rng.uniform(0, 500, n), np.zeros(n)], 1)
    b = np.stack([rng.uniform(0, 500, n), np.zeros(n), rng.uniform(0, 500, n)], 1)
    pts = np.concatenate([a, b]) + rng.normal(0, 0.3, (2 * n, 3))
    np.savetxt(tmp_path / "scan000.3d", pts, fmt="%.2f")
    (tmp_path / "scan000.pose").write_text("0 0 0\n0 0 0\n")
    (tmp_path / "hough.cfg").write_text(
        "MaxPointPlaneDist 3.0\nMaxPlanes 4\nMinSizeAllPoints 400\nRhoMax 1000\n"
        "ThetaNum 120\nPhiNum 90\n"
    )
    # -C plus an explicit --max-planes: the flag wins over MaxPlanes
    args = [str(tmp_path), "-C", str(tmp_path / "hough.cfg"), "-p", algo,
            "--max-planes", "3", "-q"]
    assert jplanes_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert tplanes_cli.main(args + ["-o", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    jp, tp = _read_planes(tmp_path / "jax"), _read_planes(tmp_path / "torch")
    assert 2 <= len(tp) <= 3
    assert_planes_match(tp, jp)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
