"""The port's thermal mapping (``models.thermo``) and camera calibration
(``models.calibration``) against the JAX package's, on the same numpy
inputs, on the CPU (``device="cpu"``).

Bounds: projected pixels within 1e-9 px (1e-12 relative off the image,
where points near the camera plane project to 1e7 px) with equal valid
masks and equal gathered colours (the same f64 formulas, in the same order);
``detect_caliboard``'s centre within 1e-2 cm and its normal and inliers
equal on tests/test_aux_modules.py's scene; ``dlt_projection`` within
1e-9 (the same numpy code); ``calibrate_camera`` within 1e-6 relative
(f64 ``torch.func`` against f64 ``jax.grad``/``jax.hessian``); a damped
system that is exactly singular is a rejected step in both packages;
chessboard corners within 1e-6 px and ``calibrate_from_chessboard_images``
within 1e-6 relative on the JAX test's renders (integer images: the
integral images are exact in any summation order).
"""

import numpy as np
import pytest
import torch

from tpu3dtk.models import calibration as jcal
from tpu3dtk.models import thermo as jth
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import calibration as tcal
from tpu3dtk_torch.models import thermo as tth


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera_fields(dist=(0.0,) * 5, rot=0.0):
    c, s = np.cos(rot), np.sin(rot)
    return dict(fx=640.0, fy=610.0, cx=320.0, cy=256.0, width=640, height=512, dist=dist,
                R=np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]), t=np.array([5.0, -3.0, 20.0]))


@pytest.mark.parametrize("dist", [(0.0,) * 5, (-0.21, 0.08, 0.001, -0.0015, -0.01)])
def test_project_and_colorize_match(dist):
    rng = np.random.default_rng(7)
    pts = rng.uniform(-400, 400, (20000, 3))
    pts[:, 2] = rng.uniform(-100, 900, 20000)
    f = _camera_fields(dist, rot=0.2)
    jc, tc = jth.Camera(**f), interop.camera_from_numpy(f)
    uj, vj, okj = jth.project_points(pts, jc)
    up, vp, okp = tth.project_points(pts, tc, device="cpu")
    assert np.array_equal(okp.numpy(), okj) and okj.sum() > 1000
    np.testing.assert_allclose(up.numpy()[okj], uj[okj], atol=1e-9, rtol=0)
    np.testing.assert_allclose(vp.numpy()[okj], vj[okj], atol=1e-9, rtol=0)
    # off the image (points near the camera plane reach 1e7 px): 1e-12 relative
    np.testing.assert_allclose(up.numpy(), uj, atol=1e-9, rtol=1e-12)
    np.testing.assert_allclose(vp.numpy(), vj, atol=1e-9, rtol=1e-12)
    for img in (rng.uniform(0, 60, (512, 640)), rng.integers(0, 255, (512, 640, 3), dtype=np.uint8)):
        valj, mj = jth.colorize_scan(pts, img, jc)
        valp, mp = tth.colorize_scan(pts, img, tc, device="cpu")
        assert np.array_equal(mp.numpy(), mj)
        assert np.array_equal(valp.numpy(), valj)


def test_colorize_rounds_half_to_even():
    f = dict(fx=1.0, fy=1.0, cx=0.0, cy=0.0, width=8, height=8)
    pts = np.array([[2.5, 3.5, 1.0], [1.5, 0.5, 1.0], [4.5, 6.5, 1.0]])
    img = np.arange(64.0).reshape(8, 8)
    vj, _ = jth.colorize_scan(pts, img, jth.Camera(**f))
    vp, _ = tth.colorize_scan(pts, img, interop.camera_from_numpy(f), device="cpu")
    assert np.array_equal(vp.numpy(), vj)


def test_detect_caliboard_match():
    """tests/test_aux_modules.py::test_detect_caliboard's scene."""
    rng = np.random.default_rng(42)
    u = rng.uniform(-50, 50, 800)
    v = rng.uniform(-30, 30, 800)
    board = np.stack([u, v, np.full(800, 200.0)], axis=1)
    clutter = rng.uniform(-400, 400, (400, 3))
    clutter[:, 2] = rng.uniform(300, 800, 400)
    pts = np.concatenate([board, clutter])
    cj, nj, ij = jth.detect_caliboard(pts, (100.0, 60.0), min_inliers=200)
    cp, n_p, ip = tth.detect_caliboard(pts, (100.0, 60.0), min_inliers=200, device="cpu")
    assert np.abs(cp - cj).max() < 1e-2
    np.testing.assert_allclose(n_p, nj, atol=1e-9)
    assert np.array_equal(ip, ij)


def test_dlt_projection_match():
    rng = np.random.default_rng(3)
    X = rng.uniform(-50, 50, (40, 3)) + [0, 0, 300]
    x = rng.uniform(0, 640, (40, 2))
    np.testing.assert_allclose(tcal.dlt_projection(X, x), jcal.dlt_projection(X, x), atol=1e-9, rtol=0)


def _pairs(seed, noise, k1=0.0):
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = 500.0, 480.0, 320.0, 240.0
    X = rng.uniform(-50, 50, (120, 3))
    X[:, 2] += 100.0
    p = X + np.array([5.0, -3.0, 120.0])
    xn, yn = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
    rad = 1.0 + k1 * (xn * xn + yn * yn)
    x = np.stack([fx * xn * rad + cx, fy * yn * rad + cy], axis=1)
    return X, x + rng.normal(0, noise, x.shape)


KEYS = ("fx", "fy", "cx", "cy", "k1", "k2", "rms_px")


@pytest.mark.parametrize("seed,noise,k1", [(42, 0.05, 0.0), (5, 0.0, -0.05)])
def test_calibrate_camera_match(seed, noise, k1):
    X, x = _pairs(seed, noise, k1)
    rj = jcal.calibrate_camera(X, x)
    rp = tcal.calibrate_camera(X, x, device="cpu")
    for k in KEYS:
        assert abs(rp[k] - rj[k]) <= 1e-6 * max(abs(rj[k]), 1.0), (k, rp[k], rj[k])
    np.testing.assert_allclose(rp["R"], rj["R"], atol=1e-6)
    np.testing.assert_allclose(rp["t"], rj["t"], rtol=1e-6, atol=1e-6)


def test_singular_damped_system_is_a_rejected_step(monkeypatch):
    """A Hessian of all -1e-9: its damped form H + lam·diag(diag(H) + 1e-9)
    is exactly rank one for every lam.  The JAX package's solve returns
    inf/NaN there (never raising), the step is rejected and the result is
    the DLT start; the port's ``solve_ex`` branch must do the same."""
    import jax
    import jax.numpy as jnp

    X, x = _pairs(42, 0.05)
    monkeypatch.setattr(jax, "hessian", lambda f: (lambda p: jnp.full((12, 12), -1e-9)))
    monkeypatch.setattr(torch.func, "hessian",
                        lambda f: (lambda p: torch.full((12, 12), -1e-9, dtype=torch.float64)))
    rj = jcal.calibrate_camera(X, x, iterations=12)
    rp = tcal.calibrate_camera(X, x, iterations=12, device="cpu")
    P = jcal.dlt_projection(X, x)
    K, _R, _t = jcal._decompose_P(P)
    for k in KEYS:
        assert abs(rp[k] - rj[k]) <= 1e-9 * max(abs(rj[k]), 1.0), (k, rp[k], rj[k])
    assert abs(rp["fx"] - K[0, 0]) < 1e-9 and rp["k1"] == 0.0


def _render(rx, ry, tz, cols=7, rows=5, sq=30.0, f=500.0, cx=320.0, cy=240.0):
    """tests/test_aux_modules.py's chessboard render."""
    cr, sr = np.cos(rx), np.sin(rx)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    cr, sr = np.cos(ry), np.sin(ry)
    Ry = np.array([[cr, 0, sr], [0, 1, 0], [-sr, 0, cr]])
    R = Ry @ Rx
    t = np.array([-sq * (cols + 1) / 2, -sq * (rows + 1) / 2, tz])
    img = np.zeros((480, 640))
    yy, xx = np.mgrid[0:480, 0:640]
    d = np.stack([(xx - cx) / f, (yy - cy) / f, np.ones_like(xx)], -1)
    d = d @ np.linalg.inv(R).T
    o = np.linalg.inv(R) @ (-t)
    lam = -o[2] / d[..., 2]
    bx = o[0] + lam * d[..., 0]
    by = o[1] + lam * d[..., 1]
    inside = (bx > 0) & (bx < (cols + 1) * sq) & (by > 0) & (by < (rows + 1) * sq) & (lam > 0)
    par = (np.floor(bx / sq) + np.floor(by / sq)) % 2
    img[inside] = np.where(par[inside] > 0, 1.0, 0.0)
    return img


def test_chessboard_match():
    imgs = [_render(0.15, -0.1, 400.0), _render(-0.2, 0.15, 450.0), _render(0.05, 0.25, 380.0)]
    for img in imgs:
        cj = jcal.detect_chessboard(img, (7, 5))
        cp = tcal.detect_chessboard(img, (7, 5), device="cpu")
        assert cj is not None and cp is not None
        np.testing.assert_allclose(cp, cj, atol=1e-6, rtol=0)
    assert tcal.detect_chessboard(np.zeros((120, 160)), (7, 5), device="cpu") is None
    Kj, rms_j, used_j = jcal.calibrate_from_chessboard_images(imgs, (7, 5), 30.0)
    Kp, rms_p, used_p = tcal.calibrate_from_chessboard_images(imgs, (7, 5), 30.0, device="cpu")
    assert used_p == used_j == 3
    np.testing.assert_allclose(Kp, Kj, rtol=1e-6, atol=1e-9)
    assert abs(rms_p - rms_j) <= 1e-6 * max(rms_j, 1.0)
