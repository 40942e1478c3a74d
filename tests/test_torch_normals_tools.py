"""The rest of the normals of the port (``ops.normals``: adaptive,
approximate and panorama estimators, ``knn_pca_features``) and the
``torchnormals`` / ``torchscan_red`` tools against the JAX package's, on
the same numpy inputs: a noisy, unreduced room around the scanner (the
lattice ties of reduced clouds rank differently in the two packages,
ROADMAP queue 3).

Bounds:
- every estimator and ``knn_pca_features``: at least 99% of the points
  have their normal within 1° of the JAX package's and (for the
  features) their curvature within 1e-4.  For the panorama estimator
  these are the points whose pixel window lets an f32 solver resolve its
  normal to 1°.  The closed-form f32 solvers of both packages give the
  smallest eigenvector of a symmetric 3x3 within u/g² + 1e-3 rad of the
  exact one (u = 2^-24, g = (λ1 − λ0)/λ2 ≥ 1e-3;
  ``test_closed_form_eigenvector_error_bound``), so two of them agree to
  ``tol`` wherever g ≥ sqrt(u / (tol/2 − 1e-3)): 2.8e-3 for 1°.  Below
  that (windows of one or two points, windows of nearly collinear
  points, windows mixing points metres apart where ``np.roll`` wraps the
  top row onto the bottom one) they pick different vectors of a
  near-degenerate space.
- ``torchnormals --device cpu -r -1`` against ``tpunormals -r -1`` for
  each ``-g``: the same points, the same file layout and pose files,
  normals as above.
- ``torchscan_red --device cpu`` against ``tpuscan_red``: OCTREE with
  ``--octree 0`` (voxel centres) within 1e-3 cm; RANGE and INTERPOLATE
  byte-identical files (host numpy in both packages).
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_room_cloud
from tpu3dtk.cli import calc_normals as jnormals_cli
from tpu3dtk.cli import scan_red as jscan_red
from tpu3dtk.ops import normals as jnormals
from tpu3dtk_torch.cli import calc_normals as tnormals_cli
from tpu3dtk_torch.cli import scan_red as tscan_red
from tpu3dtk_torch.ops import normals as tnormals
from tpu3dtk_torch.synth import write_scan_dir


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy_room(seed, n=1800):
    """A 300 cm room centred on the scanner, 1 cm sensor noise."""
    rng = np.random.default_rng(seed)
    cloud = make_room_cloud(rng, n=n, size=300.0)
    cloud = cloud - 150.0 + rng.normal(0, 1.0, cloud.shape)
    return cloud.astype(np.float32)


# the closed-form f32 solver's error: u/g² + SOLVER_FLOOR rad (see the
# module docstring)
F32_U = 2.0**-24
SOLVER_FLOOR = 1e-3


def resolvable_gap(tol_deg):
    """The least relative eigengap at which two f32 solvers, each within
    the bound above of the exact vector, agree to ``tol_deg``."""
    return math.sqrt(F32_U / (math.radians(tol_deg) / 2 - SOLVER_FLOOR))


def _resolvable(points, width=720, height=240, tol_deg=1.0):
    """Per point of [N,3]: whether the f32 covariance of its panorama
    window (the estimator's own) has a relative eigengap of at least
    ``resolvable_gap(tol_deg)``."""
    from tpu3dtk_torch.ops.panorama import PanoramaParams, point_pixels

    pts = np.asarray(points, np.float64)
    params = PanoramaParams(method="equirectangular", width=width, height=height)
    cov = tnormals._window_covariances(pts, params).astype(np.float32).astype(np.float64)
    lam = np.linalg.eigvalsh(cov)
    gap = (lam[..., 1] - lam[..., 0]) / np.maximum(lam[..., 2], 1e-30)
    ui, vi, _valid = point_pixels(pts, params)
    return gap[vi, ui] >= resolvable_gap(tol_deg)


@pytest.mark.parametrize("solver", ["port", "jax"])
def test_closed_form_eigenvector_error_bound(solver):
    """Random symmetric 3x3 spectra at relative gaps from 1e-3 to 3e-2
    (planar, linear and in-between windows, scales over seven decades):
    the f32 solver's vector within u/g² + SOLVER_FLOOR rad of numpy's f64
    eigenvector of the same f32 matrix."""
    rng = np.random.default_rng(11)
    n = 40000
    for g in (1e-3, 3e-3, 1e-2, 3e-2):
        Q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
        mode = rng.integers(0, 3, n)
        lam1 = np.where(mode == 0, g + (1 - g) * rng.random(n),
                        np.where(mode == 1, g * (1 + rng.random(n)), 1 - g * rng.random(n)))
        lam = np.stack([np.clip(lam1 - g, 0, None), lam1, np.ones(n)], 1)
        lam *= 10 ** rng.uniform(-2, 5, (n, 1))
        A = np.einsum("nij,nj,nkj->nik", Q, lam, Q).astype(np.float32)
        if solver == "port":
            v = tnormals.smallest_eigenvector_sym3(torch.as_tensor(A)).numpy()
        else:
            v = np.asarray(jnormals.smallest_eigenvector_sym3(jnp.asarray(A)))
        w, vec = np.linalg.eigh(A.astype(np.float64))
        gr = (w[:, 1] - w[:, 0]) / w[:, 2]
        theta = np.arccos(np.clip(np.abs((v * vec[:, :, 0]).sum(-1)), 0.0, 1.0))
        assert (theta <= F32_U / gr**2 + SOLVER_FLOOR).all(), (g, theta.max())


def _agree(tn, jn, deg=1.0):
    """Share of rows whose normals are within ``deg`` (sign included)."""
    c = np.clip((np.asarray(tn, np.float64) * np.asarray(jn, np.float64)).sum(-1), -1.0, 1.0)
    return np.degrees(np.arccos(c)) <= deg


def _jax_args(pts):
    return jnp.asarray(pts), jnp.ones(len(pts), bool), jnp.zeros(3, jnp.float32)


def _torch_args(pts):
    return torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool), torch.zeros(3)


@pytest.mark.parametrize("seed", [0, 1])
def test_adaptive_knn_matches_jax(seed):
    pts = _noisy_room(seed)
    jn = np.asarray(jnormals.estimate_normals_adaptive_knn(*_jax_args(pts)))
    tn = tnormals.estimate_normals_adaptive_knn(*_torch_args(pts)).numpy()
    assert _agree(tn, jn).mean() >= 0.99
    assert np.allclose(np.linalg.norm(tn, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("subsample", [1, 4])
def test_apx_knn_matches_jax(subsample):
    pts = _noisy_room(2)
    jn = np.asarray(jnormals.estimate_normals_apx_knn(
        *_jax_args(pts), k=12, subsample=subsample, seed=5))
    tn = tnormals.estimate_normals_apx_knn(
        pts, np.ones(len(pts), bool), np.zeros(3), k=12, subsample=subsample, seed=5,
        device="cpu").numpy()
    assert _agree(tn, jn).mean() >= 0.99


def test_panorama_normals_match_jax():
    pts = _noisy_room(3, n=20000)
    jn = jnormals.estimate_normals_panorama(pts, width=180, height=60)
    tn = tnormals.estimate_normals_panorama(pts, width=180, height=60, device="cpu")
    assert tn.dtype == jn.dtype and tn.shape == jn.shape
    good = _resolvable(pts, 180, 60)
    assert good.mean() >= 0.9
    assert _agree(tn[good], jn[good]).mean() >= 0.99


@pytest.mark.parametrize("viewpoint", [None, (10.0, -20.0, 5.0)])
def test_knn_pca_features_match_jax(viewpoint):
    pts = _noisy_room(4)
    jn, jc = jnormals.knn_pca_features(pts, k=16, viewpoint=viewpoint)
    tn, tc = tnormals.knn_pca_features(pts, k=16, viewpoint=viewpoint, device="cpu")
    ok = _agree(tn, jn) & (np.abs(tc - np.asarray(jc)) <= 1e-4)
    assert ok.mean() >= 0.99
    assert tc.shape == (len(pts),) and (tc >= -1e-6).all() and (tc <= 1 / 3 + 1e-6).all()


def _scan_dir(root, n_scans=2, n_pts=1200):
    locals_ = [_noisy_room(10 + k, n=n_pts) for k in range(n_scans)]
    poses = [np.eye(4) for _ in range(n_scans)]
    for k, T in enumerate(poses):
        T[:3, 3] = [25.0 * k, 0.0, 10.0 * k]
    return write_scan_dir(str(root), locals_, poses)


def _read_xyzn(path):
    return np.loadtxt(path).reshape(-1, 6)


@pytest.mark.parametrize("ntype", ["knn", "adaptive", "apx", "panorama"])
def test_normals_cli_matches_jax(tmp_path, ntype):
    # the panorama's default 720 x 240 image needs a dense scan to fill
    # its pixel windows
    idents = _scan_dir(tmp_path / "scans", *((1, 120000) if ntype == "panorama" else ()))
    args = [str(tmp_path / "scans"), "-r", "-1", "-g", ntype, "-K", "12", "-q"]
    assert jnormals_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert tnormals_cli.main(args + ["-o", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    for ident in idents:
        j = _read_xyzn(tmp_path / "jax" / f"scan{ident}.3d")
        t = _read_xyzn(tmp_path / "torch" / f"scan{ident}.3d")
        np.testing.assert_array_equal(t[:, :3], j[:, :3])
        rows = np.ones(len(t), bool)
        if ntype == "panorama":
            rows = _resolvable(t[:, :3])
            assert rows.mean() >= 0.8
        assert _agree(t[rows, 3:], j[rows, 3:]).mean() >= 0.99
        assert (tmp_path / "torch" / f"scan{ident}.pose").read_text() == (
            tmp_path / "jax" / f"scan{ident}.pose").read_text()


@pytest.mark.parametrize("mode", [
    ["-r", "OCTREE", "-v", "10", "--octree", "0"],
    ["-r", "RANGE", "-W", "360", "-H", "100"],
    ["-r", "INTERPOLATE", "-W", "360", "-H", "100", "-m", "400"],
])
def test_scan_red_cli_matches_jax(tmp_path, mode, capsys):
    idents = _scan_dir(tmp_path / "scans")
    args = [str(tmp_path / "scans")] + mode
    assert jscan_red.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert tscan_red.main(args + ["-o", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    n = len(idents)  # a line a scan, then "reduced N scans -> DIR"
    assert out[n + 1 : 2 * n + 1] == out[:n]
    for ident in idents:
        jp = (tmp_path / "jax" / f"scan{ident}.3d").read_text()
        tp = (tmp_path / "torch" / f"scan{ident}.3d").read_text()
        if mode[1] == "OCTREE":
            np.testing.assert_allclose(np.loadtxt(tp.splitlines()), np.loadtxt(jp.splitlines()),
                                       atol=1e-3)
        else:
            assert tp == jp
        assert (tmp_path / "torch" / f"scan{ident}.pose").read_text() == (
            tmp_path / "jax" / f"scan{ident}.pose").read_text()
