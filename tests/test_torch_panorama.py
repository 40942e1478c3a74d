"""The port's numpy copy of the panorama projections
(``tpu3dtk_torch.ops.panorama``) against ``tpu3dtk.ops.panorama``: the
same outputs bit for bit, for every method, on the inputs of
tests/test_panorama_zoo.py."""

import dataclasses

import numpy as np
import pytest

from tpu3dtk.ops import panorama as jpano
from tpu3dtk_torch.ops import panorama as tpano

NARROW = ("rectilinear", "pannini", "stereographic", "azimuthal")


def _room_cloud(n=4000, seed=0):
    """Points on the walls of a box room around the origin (as
    tests/test_panorama_zoo.py builds them)."""
    rng = np.random.default_rng(seed)
    pts = []
    for ax in range(3):
        for sign in (-1.0, 1.0):
            p = rng.uniform(-300, 300, (n // 6, 3))
            p[:, ax] = sign * 300.0
            pts.append(p)
    return np.concatenate(pts)


def _params(mod, method, **kw):
    if method in NARROW:
        kw.update(min_h_angle=-0.9, max_h_angle=0.9, min_v_angle=-0.7, max_v_angle=0.7)
    return mod.PanoramaParams(method=method, **kw)


def test_same_surface():
    assert tpano.METHODS == jpano.METHODS
    assert [f.name for f in dataclasses.fields(tpano.PanoramaParams)] == [
        f.name for f in dataclasses.fields(jpano.PanoramaParams)]
    assert tpano.PanoramaParams() == tpano.PanoramaParams(**vars(jpano.PanoramaParams()))


@pytest.mark.parametrize("method", jpano.METHODS)
def test_projection_and_recovery_bit_identical(method):
    pts = _room_cloud()
    refl = np.linalg.norm(pts, axis=1).astype(np.float32)
    jp, tp = _params(jpano, method, width=360, height=180), _params(tpano, method, width=360, height=180)
    ja, ta = jpano.project_panorama(pts, jp, refl), tpano.project_panorama(pts, tp, refl)
    for name in ("range", "index", "reflectance"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name))
    np.testing.assert_array_equal(ta.to_image(), ja.to_image())
    uv = np.random.default_rng(1).uniform(0, 180, (50, 2))
    for t, j in zip(ta.back_project(uv), ja.back_project(uv)):
        np.testing.assert_array_equal(t, j)
    for t, j in zip(tpano.point_pixels(pts, tp), jpano.point_pixels(pts, jp)):
        np.testing.assert_array_equal(t, j)
    (tr, trefl), (jr, jrefl) = (
        tpano.recover_point_cloud(ta.range, tp, ta.reflectance),
        jpano.recover_point_cloud(ja.range, jp, ja.reflectance),
    )
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(trefl, jrefl)


@pytest.mark.parametrize("fn", ["reduce_range", "reduce_interpolate"])
@pytest.mark.parametrize("max_range", [None, 500.0])
def test_reductions_bit_identical(fn, max_range):
    pts = _room_cloud(seed=3)
    refl = np.linalg.norm(pts, axis=1).astype(np.float32)
    kw = dict(width=400, height=200, max_range=max_range)
    tr, trefl = getattr(tpano, fn)(pts, tpano.PanoramaParams(**kw), scale=0.5, reflectance=refl)
    jr, jrefl = getattr(jpano, fn)(pts, jpano.PanoramaParams(**kw), scale=0.5, reflectance=refl)
    assert tr.dtype == jr.dtype and len(tr) > 100
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(trefl, jrefl)
