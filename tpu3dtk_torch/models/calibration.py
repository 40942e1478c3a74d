"""Camera calibration — the port of ``tpu3dtk.models.calibration`` (ref
src/calibration/CalibrationToolbox.cc / Calibrator.cc: estimate camera
intrinsics + extrinsics from 3D↔2D pattern correspondences; the
reference wraps OpenCV's calibrateCamera and pattern detectors).

DLT initialization (closed form, numpy f64) followed by
Levenberg-Marquardt on the reprojection error, with the gradient and
Hessian from ``torch.func`` in f64 (the JAX package runs ``jax.grad`` /
``jax.hessian`` under x64).  The damped system is solved with
``torch.linalg.solve_ex``: like ``jnp.linalg.solve`` it never raises, and
a singular system is a rejected step, as the JAX package's NaN step is.

Chessboard detection: the box-filter checker response runs in f64 on the
image's device; labelling (``scipy.ndimage``), the homography bootstrap
and the sub-pixel centroids stay on the host, as in the JAX package.
Integral images summed on a card add in another order than numpy's
``cumsum``; on integer-valued images the sums are exact.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "dlt_projection", "calibrate_camera", "reprojection_error", "detect_chessboard",
    "calibrate_from_chessboard_images",
]


def dlt_projection(points3d: np.ndarray, points2d: np.ndarray) -> np.ndarray:
    """Closed-form DLT estimate of the 3x4 projection matrix from >= 6
    correspondences (the classic initializer)."""
    X = np.asarray(points3d, np.float64)
    x = np.asarray(points2d, np.float64)
    n = len(X)
    A = np.zeros((2 * n, 12))
    A[0::2, 0:3] = X
    A[0::2, 3] = 1
    A[0::2, 8:11] = -x[:, 0:1] * X
    A[0::2, 11] = -x[:, 0]
    A[1::2, 4:7] = X
    A[1::2, 7] = 1
    A[1::2, 8:11] = -x[:, 1:2] * X
    A[1::2, 11] = -x[:, 1]
    _, _, Vt = np.linalg.svd(A)
    P = Vt[-1].reshape(3, 4)
    if np.linalg.det(P[:, :3]) < 0:
        P = -P
    return P


def _decompose_P(P):
    """P -> (K upper-triangular, R, t) via RQ decomposition."""
    M = P[:, :3]
    # RQ via flipped QR
    F = np.flipud(np.fliplr(np.eye(3)))
    Q, R_ = np.linalg.qr((F @ M).T)
    K = F @ R_.T @ F
    R = F @ Q.T
    # positive diagonal of K
    S = np.diag(np.sign(np.diag(K)))
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:
        R = -R
        K = -K
    t = np.linalg.solve(K, P[:, 3])
    K = K / K[2, 2]
    return K, R, t


def reprojection_error(params, X, x):
    """Mean squared reprojection error (differentiable by ``torch.func``).
    params = [fx, fy, cx, cy, rx, ry, rz, tx, ty, tz, k1, k2]; X [N,3],
    x [N,2], all f64 tensors on one device."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    rvec = params[4:7]
    t = params[7:10]
    k1, k2 = params[10], params[11]
    # Rodrigues
    th = torch.sqrt(torch.sum(rvec**2) + 1e-20)
    k = rvec / th
    zero = torch.zeros((), dtype=params.dtype, device=params.device)
    Kx = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    eye = torch.eye(3, dtype=params.dtype, device=params.device)
    R = eye + torch.sin(th) * Kx + (1.0 - torch.cos(th)) * (Kx @ Kx)
    p = X @ R.T + t
    z = torch.where(torch.abs(p[:, 2]) < 1e-9, 1e-9, p[:, 2])
    xn = p[:, 0] / z
    yn = p[:, 1] / z
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    u = fx * xn * radial + cx
    v = fy * yn * radial + cy
    du = u - x[:, 0]
    dv = v - x[:, 1]
    return torch.mean(du * du + dv * dv)


def calibrate_camera(
    points3d: np.ndarray,
    points2d: np.ndarray,
    iterations: int = 200,
    device=None,
) -> dict:
    """Estimate intrinsics (fx, fy, cx, cy, k1, k2) + extrinsics (R, t)
    from 3D↔2D correspondences: DLT init + autodiff Levenberg-Marquardt
    on the reprojection error (the calibrateCamera role), on ``device``
    (None: the first CUDA card)."""
    X = np.asarray(points3d, np.float64)
    x = np.asarray(points2d, np.float64)
    P = dlt_projection(X, x)
    K, R, t = _decompose_P(P)
    # Rodrigues vector from R
    th = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    if th < 1e-9:
        rvec = np.zeros(3)
    else:
        rvec = (
            th
            / (2 * np.sin(th))
            * np.array(
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
            )
        )
    p0 = np.array(
        [K[0, 0], K[1, 1], K[0, 2], K[1, 2], *rvec, *t, 0.0, 0.0],
        np.float64,
    )

    if device is None:
        from .. import default_device

        device = default_device()
    dev = torch.device(device)
    Xt = torch.as_tensor(X, device=dev)
    xt = torch.as_tensor(x, device=dev)

    def err_fn(p):
        return reprojection_error(p, Xt, xt)

    grad_fn = torch.func.grad_and_value(err_fn)
    hess_fn = torch.func.hessian(err_fn)

    p = torch.as_tensor(p0, device=dev)
    lam = 1e-3
    g, e = grad_fn(p)
    for _ in range(iterations):
        H = hess_fn(p)
        Hl = H + lam * torch.diag(torch.diagonal(H) + 1e-9)
        step, info = torch.linalg.solve_ex(Hl, g)
        if int(info) != 0:
            # a singular system: the JAX package's solve returns inf/NaN
            # there, its error is no smaller, and the step is rejected
            lam = min(lam * 4.0, 1e6)
            continue
        p_new = p - step
        g_new, e_new = grad_fn(p_new)
        if float(e_new) < float(e):
            p, e, g = p_new, e_new, g_new
            lam = max(lam * 0.5, 1e-9)
            if float(torch.linalg.norm(step)) < 1e-10:
                break
        else:
            lam = min(lam * 4.0, 1e6)
    p = p.cpu().numpy()
    e = float(e)
    rvec = p[4:7]
    th = np.linalg.norm(rvec)
    if th < 1e-12:
        R = np.eye(3)
    else:
        k = rvec / th
        Kx = np.array(
            [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
        )
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)
    return {
        "fx": float(p[0]), "fy": float(p[1]),
        "cx": float(p[2]), "cy": float(p[3]),
        "R": R, "t": p[7:10],
        "k1": float(p[10]), "k2": float(p[11]),
        "rms_px": float(np.sqrt(e)),
    }


# ---------------------------------------------------------------------------
# Chessboard pattern detection (ref src/calibration/CalibrationToolbox.cc:
# cv::findChessboardCorners feeding the calibrate pipeline; the reference
# also bundles AprilTag/CCTag detectors in 3rdparty)
# ---------------------------------------------------------------------------
#
# TPU/numpy redesign: inner corners of a chessboard are maxima of the
# checker response |(A+D)-(B+C)| of the four quadrant means around each
# pixel — one separable box-filter pass over the whole image instead of
# OpenCV's adaptive-threshold + quad assembly.  Grid ORDERING runs
# through a homography bootstrap: the 4 extreme detected corners map to
# the unit grid, every corner is assigned its nearest ideal node, and
# one DLT refinement re-fits the homography on all assignments.


def _box_sum(img, r):
    """Summed-area box sums with radius r (inclusive window 2r+1) of an
    f64 image tensor, on its device."""
    H, W = img.shape
    ii = torch.zeros((H + 1, W + 1), dtype=img.dtype, device=img.device)
    ii[1:, 1:] = torch.cumsum(torch.cumsum(img, 0), 1)
    ar_h = torch.arange(H, device=img.device)
    ar_w = torch.arange(W, device=img.device)
    y0 = torch.clamp(ar_h - r, 0, H)
    y1 = torch.clamp(ar_h + r + 1, 0, H)
    x0 = torch.clamp(ar_w - r, 0, W)
    x1 = torch.clamp(ar_w + r + 1, 0, W)
    return (
        ii[y1][:, x1] - ii[y0][:, x1] - ii[y1][:, x0] + ii[y0][:, x0]
    )


def _checker_response(img, r):
    """|(A+D) - (B+C)| of the 4 quadrant sums around each pixel —
    maximal at chessboard inner corners, ~0 on edges and flats."""
    H, W = img.shape
    s = _box_sum(img, r)

    def shift(a, dy, dx):
        out = torch.zeros_like(a)
        ys = slice(max(0, dy), H + min(0, dy))
        yd = slice(max(0, -dy), H + min(0, -dy))
        xs = slice(max(0, dx), W + min(0, dx))
        xd = slice(max(0, -dx), W + min(0, -dx))
        out[yd, xd] = a[ys, xs]
        return out

    o = r + 1
    A = shift(s, o, o)      # up-left quadrant window
    B = shift(s, o, -o)     # up-right
    C = shift(s, -o, o)     # down-left
    D = shift(s, -o, -o)    # down-right
    return torch.abs((A + D) - (B + C))


def detect_chessboard(
    image, pattern_size: tuple[int, int],
    corner_radius: int = 5, device=None,
) -> np.ndarray | None:
    """Find the ordered inner corners of a chessboard.

    image: grayscale [H, W] float/uint8 array or tensor; pattern_size:
    (cols, rows) of INNER corners (the OpenCV convention the reference
    uses).  Returns corners [rows*cols, 2] (x, y) in row-major pattern
    order, or None when the pattern is not found.  The response runs on
    the image's device (an array goes to ``device``; None: the first
    CUDA card)."""
    if isinstance(image, torch.Tensor):
        img = image.to(torch.float64)
    else:
        if device is None:
            from .. import default_device

            device = default_device()
        img = torch.as_tensor(np.asarray(image, np.float64), device=device)
    if img.ndim != 2:
        raise ValueError("grayscale image expected")
    cols, rows = pattern_size
    n = cols * rows
    resp = _checker_response(img, corner_radius).cpu().numpy()
    # the response PLATEAUS around each true crossing (the window sees
    # four clean quadrants over a neighborhood); boundary T-junctions
    # reach at most half the plateau value.  Candidates = response-
    # weighted centroids of the connected >60% regions.
    from scipy.ndimage import center_of_mass, label

    mask = resp > 0.6 * resp.max()
    lab, nlab = label(mask)
    if nlab < n:
        return None
    cents = center_of_mass(resp, lab, np.arange(1, nlab + 1))
    pts = np.asarray(cents)[:, ::-1].astype(np.float64)  # (x, y)
    if len(pts) < n:
        return None

    # bootstrap homography from the 4 extreme corners -> unit grid
    sums = pts.sum(1)
    diffs = pts[:, 0] - pts[:, 1]
    c_tl = pts[np.argmin(sums)]
    c_br = pts[np.argmax(sums)]
    c_tr = pts[np.argmax(diffs)]
    c_bl = pts[np.argmin(diffs)]
    src = np.array([[0, 0], [cols - 1, 0], [0, rows - 1],
                    [cols - 1, rows - 1]], np.float64)
    dst = np.stack([c_tl, c_tr, c_bl, c_br])

    def homography(src, dst):
        A = []
        for (u, v), (x, y) in zip(src, dst):
            A.append([u, v, 1, 0, 0, 0, -x * u, -x * v, -x])
            A.append([0, 0, 0, u, v, 1, -y * u, -y * v, -y])
        _, _, vt = np.linalg.svd(np.asarray(A))
        return vt[-1].reshape(3, 3)

    Hm = homography(src, dst)

    def project(Hm, uv):
        p = np.concatenate([uv, np.ones((len(uv), 1))], 1) @ Hm.T
        return p[:, :2] / p[:, 2:3]

    gu, gv = np.meshgrid(np.arange(cols), np.arange(rows))
    grid = np.stack([gu.ravel(), gv.ravel()], 1).astype(np.float64)
    for _ in range(2):
        ideal = project(Hm, grid)
        d2 = ((ideal[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(1)
        if len(np.unique(assign)) < n:
            return None
        med = np.median(np.sqrt(d2[np.arange(n), assign]))
        spacing = np.linalg.norm(ideal[1] - ideal[0])
        if med > 0.5 * spacing:
            return None
        Hm = homography(grid, pts[assign])
    ordered = pts[assign]

    # sub-pixel refinement: response-weighted centroid around each peak
    out = np.zeros_like(ordered)
    r = corner_radius
    Hh, Ww = resp.shape
    for k, (x, y) in enumerate(ordered):
        x0, y0 = int(x), int(y)
        ys_ = slice(max(0, y0 - r), min(Hh, y0 + r + 1))
        xs_ = slice(max(0, x0 - r), min(Ww, x0 + r + 1))
        w = resp[ys_, xs_]
        yy, xx = np.mgrid[ys_, xs_]
        out[k] = [(w * xx).sum() / w.sum(), (w * yy).sum() / w.sum()]
    return out


def calibrate_from_chessboard_images(
    images, pattern_size, square_size: float, device=None,
):
    """Full pattern-to-intrinsics path (the CalibrationToolbox pipeline,
    src/calibration/CalibrationToolbox.cc:150-190): detect the board in
    every image, estimate per-view intrinsics from the board-plane
    homography (square pixels, zero skew — the practical single-board
    bootstrap) and average over views.  Returns (K, rms, n_used).  The
    detector's response runs on ``device`` (None: the first CUDA card)."""
    cols, rows = pattern_size
    gu, gv = np.meshgrid(np.arange(cols), np.arange(rows))
    board = np.stack(
        [gu.ravel() * square_size, gv.ravel() * square_size,
         np.zeros(cols * rows)], 1,
    )
    Ks, errs = [], []
    used = 0
    for img in images:
        c = detect_chessboard(img, pattern_size, device=device)
        if c is None:
            continue
        used += 1
        K, rms = _calibrate_planar(board, c)
        if K is not None:
            Ks.append(K)
            errs.append(rms)
    if not Ks:
        return None, np.inf, used
    return np.mean(Ks, axis=0), float(np.mean(errs)), used


def _calibrate_planar(board, corners):
    """Zhang's closed-form intrinsics from ONE planar view is
    under-determined; with the standard square-pixel/zero-skew
    assumptions (fx=fy, s=0, principal point = corner centroid) the
    single-view homography yields f in closed form (the reference's
    practical single-board bootstrap)."""
    n = len(board)
    A = []
    for (u, v), (x, y) in zip(board[:, :2], corners):
        A.append([u, v, 1, 0, 0, 0, -x * u, -x * v, -x])
        A.append([0, 0, 0, u, v, 1, -y * u, -y * v, -y])
    _, _, vt = np.linalg.svd(np.asarray(A))
    Hm = vt[-1].reshape(3, 3)
    cx, cy = corners.mean(0)
    h1, h2 = Hm[:, 0].copy(), Hm[:, 1].copy()
    h1[0] -= cx * h1[2]
    h1[1] -= cy * h1[2]
    h2[0] -= cx * h2[2]
    h2[1] -= cy * h2[2]
    # orthogonality of r1, r2: h1ᵀ K⁻ᵀK⁻¹ h2 = 0 with K = diag(f, f, 1)
    num = h1[0] * h2[0] + h1[1] * h2[1]
    den = -h1[2] * h2[2]
    if den == 0 or num / den <= 0:
        return None, np.inf
    f = float(np.sqrt(num / den))
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    # reprojection via the homography (planar ground truth)
    p = np.concatenate([board[:, :2], np.ones((n, 1))], 1) @ Hm.T
    proj = p[:, :2] / p[:, 2:3]
    rms = float(np.sqrt(((proj - corners) ** 2).sum(1).mean()))
    return K, rms
