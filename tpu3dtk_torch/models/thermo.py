"""Thermal/color image → point-cloud mapping — the port of
``tpu3dtk.models.thermo`` (ref src/thermo/thermo.cc: project laser points
into a calibrated (thermal) camera and attach per-point
temperature/color; caliboard.cc detects the heated calibration board in
the cloud).

Projection is one batched pinhole + Brown-Conrady transform in f64 on
the device (the terms in the JAX package's order); the image lookup is a
gather there (``torch.round`` rounds half to even, as ``np.round``).
Board detection runs the port's Hough planes (``models.shapes``) with
the JAX package's accumulator sizing and the f64 ``eigh`` extent gate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Camera",
    "project_points",
    "colorize_scan",
    "detect_caliboard",
]


@dataclasses.dataclass
class Camera:
    """Pinhole + Brown-Conrady distortion (the cv::projectPoints model
    used by thermo.cc / calibration)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    # distortion [k1, k2, p1, p2, k3]
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    # extrinsics: camera-from-scan (R [3,3], t [3])
    R: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    t: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )


def _device(x, device):
    if isinstance(x, torch.Tensor):
        return x.device
    if device is None:
        from .. import default_device

        return default_device()
    return torch.device(device)


def project_points(points, cam: Camera, device=None):
    """[N,3] scan-frame points -> (u [N], v [N], valid [N]) as f64 / bool
    tensors on the points' device (an array goes to ``device``; None:
    the first CUDA card).

    valid requires z > 0 in the camera frame and the pixel inside the
    image (thermo.cc projectAndMap gate)."""
    dev = _device(points, device)
    pts = torch.as_tensor(points, device=dev).to(torch.float64)
    R = torch.as_tensor(np.asarray(cam.R, np.float64), device=dev)
    t = torch.as_tensor(np.asarray(cam.t, np.float64), device=dev)
    p = pts @ R.T + t
    z = p[:, 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    x = p[:, 0] / zs
    y = p[:, 1] / zs
    k1, k2, p1, p2, k3 = (float(v) for v in cam.dist)
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    u = cam.fx * xd + cam.cx
    v = cam.fy * yd + cam.cy
    valid = (
        (z > 0)
        & (u >= 0) & (u <= cam.width - 1)
        & (v >= 0) & (v <= cam.height - 1)
    )
    return u, v, valid


def colorize_scan(points, image, cam: Camera, device=None):
    """Attach per-point image values (temperature / RGB): project and
    gather (the thermo.cc point-coloring loop).  Returns (values [N, C]
    or [N], valid [N]) as tensors on the points' device; invalid points
    get 0."""
    u, v, valid = project_points(points, cam, device)
    img = torch.as_tensor(np.asarray(image), device=u.device)
    ui = torch.clamp(torch.round(u).to(torch.int64), 0, cam.width - 1)
    vi = torch.clamp(torch.round(v).to(torch.int64), 0, cam.height - 1)
    vals = img[vi, ui]
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    if vals.ndim == 1:
        return torch.where(valid, vals, zero), valid
    return torch.where(valid[:, None], vals, zero), valid


def detect_caliboard(
    points,
    board_size: tuple[float, float],
    tol: float = 0.25,
    dist_tol: float = 5.0,
    min_inliers: int = 100,
    device=None,
):
    """Find the calibration-board plane in a cloud (caliboard.cc role):
    Hough plane detection gated to the known board extent.  Returns
    (center [3], normal [3], inlier mask [N] bool) as numpy, or None.
    Runs on the points' device (an array goes to ``device``; None: the
    first CUDA card)."""
    from .shapes import HoughParams, detect_planes

    dev = _device(points, device)
    pts = torch.as_tensor(points, device=dev).to(torch.float64)
    # rho bins matched to the board tolerance: with coarse bins a tilted
    # accumulator cell can out-vote the true plane of a SMALL board
    # (its thin footprint fits inside one wide rho band at many angles)
    rho_max = float(pts.abs().max()) + 1.0
    n_rho = max(int(np.ceil(2 * rho_max / max(dist_tol, 1e-3))), 100)
    planes = detect_planes(
        pts,
        HoughParams(
            min_inliers=min_inliers, max_planes=8, dist_tol=dist_tol,
            rho_max=rho_max, n_rho=min(n_rho, 2048),
        ),
    )
    w, h = board_size
    for pl in planes:
        n_t = torch.as_tensor(np.asarray(pl.normal, np.float64), device=dev)
        inl = (pts @ n_t - pl.rho).abs() < dist_tol
        sel = pts[inl]
        if len(sel) < min_inliers:
            continue
        # measure the in-plane extent
        c = sel.mean(0)
        cen = sel - c
        cov = (cen.T @ cen / len(sel)).cpu().numpy()
        wvals, _V = np.linalg.eigh(cov)
        e1 = 4.0 * np.sqrt(wvals[2])  # ~full extent along major axes
        e2 = 4.0 * np.sqrt(wvals[1])
        if (
            abs(e1 - max(w, h)) < tol * max(w, h)
            and abs(e2 - min(w, h)) < tol * max(w, h)
        ):
            return c.cpu().numpy(), pl.normal, inl.cpu().numpy()
    return None
