"""Panorama projections of 3D scans — a numpy copy of
``tpu3dtk.ops.panorama`` (the port keeps its own so it imports nothing
of the JAX package; same code, the same outputs bit for bit): the fbr
``panorama``/``projection`` pair (ref src/slam6d/fbr/projection.cc:552-830 forward,
:332-460 recoverPointCloud; methods from include/slam6d/fbr/fbr_global.h:64-75).

Design: every projection is expressed as a pure vectorized pair
  forward(azim, elev)  -> plane coordinates (X, Y) + validity
  inverse(X, Y)        -> (azim, elev)
on [N]-shaped angle arrays (no per-point branching, unlike the
reference's per-pixel switch).  Plane bounds are sampled once from the
field-of-view boundary, pixels are normalized [0,1]² coordinates, and
rasterisation is a z-buffered scatter (nearest wins).  The exact inverse
gives lossless back-projection for scan_red's RANGE / INTERPOLATE
reductions (src/slam6d/scan_red.cc:81,201-207) and range-image normals.

Methods: equirectangular, cylindrical, mercator, miller,
equalareacylindrical, conic (Albers), stereographic, rectilinear
(gnomonic), pannini, azimuthal (Lambert equal-area).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "PanoramaParams",
    "Panorama",
    "project_panorama",
    "recover_point_cloud",
    "reduce_range",
    "reduce_interpolate",
    "METHODS",
]

METHODS = (
    "equirectangular",
    "cylindrical",
    "mercator",
    "miller",
    "equalareacylindrical",
    "conic",
    "stereographic",
    "rectilinear",
    "pannini",
    "azimuthal",
)


@dataclasses.dataclass
class PanoramaParams:
    width: int = 720
    height: int = 360
    method: str = "equirectangular"
    max_range: float | None = None
    min_v_angle: float = -np.pi / 3  # vertical field of view
    max_v_angle: float = np.pi / 3
    min_h_angle: float = -np.pi  # horizontal field of view
    max_h_angle: float = np.pi
    param: float = 1.0  # pannini d / stereographic R / equalarea φ_ts


def _projection_pair(p: PanoramaParams):
    """Return (forward, inverse) closures for the method.  Angles:
    azim = atan2(x, z) ∈ [-π, π], elev from the horizontal plane."""
    m = p.method
    lo, hi = p.min_v_angle, p.max_v_angle
    l0 = 0.5 * (p.min_h_angle + p.max_h_angle)  # projection center longitude
    d = p.param

    if m == "equirectangular":
        return (lambda a, e: (a, e, np.ones_like(a, bool))), (lambda X, Y: (X, Y))
    if m == "cylindrical":
        # Y = tan(elev) (projection.cc:617-629)
        return (
            lambda a, e: (a, np.tan(np.clip(e, lo, hi)), np.ones_like(a, bool))
        ), (lambda X, Y: (X, np.arctan(Y)))
    if m == "mercator":
        # Y = log(tan e + sec e) = atanh(sin e) (projection.cc:650-662)
        def fwd(a, e):
            ec = np.clip(e, lo, hi)
            return a, np.log(np.tan(ec) + 1.0 / np.cos(ec)), np.ones_like(a, bool)

        return fwd, (lambda X, Y: (X, np.arctan(np.sinh(Y))))
    if m == "miller":
        # Y = 5/4 log tan(2e/5 + π/4) (projection.cc:666-680)
        def fwd(a, e):
            ec = np.clip(e, lo, hi)
            return a, 1.25 * np.log(np.tan(0.4 * ec + np.pi / 4)), np.ones_like(a, bool)

        return fwd, (lambda X, Y: (X, 2.5 * (np.arctan(np.exp(0.8 * Y)) - np.pi / 4)))
    if m == "equalareacylindrical":
        # X = azim·cos φts, Y = sin(elev)/cos φts (projection.cc:631-647)
        c = np.cos(d)
        return (
            lambda a, e: (a * c, np.sin(np.clip(e, lo, hi)) / c, np.ones_like(a, bool))
        ), (lambda X, Y: (X / c, np.arcsin(np.clip(Y * c, -1, 1))))
    if m == "conic":
        # Albers equal-area conic, standard parallels at the FOV edges
        # (projection.cc:85-108 init + :595-612 forward, :395-401 inverse)
        lat1, lat2 = lo, hi
        n = 0.5 * (np.sin(lat1) + np.sin(lat2))
        if abs(n) < 1e-6:
            # symmetric FOV degenerates the cone into a cylinder
            # (sin lat1 = -sin lat2); move the lower parallel to the
            # mid-latitude so the cone stays well-defined
            lat1 = 0.5 * (lo + hi) + 0.25 * (hi - lo)
            n = 0.5 * (np.sin(lat1) + np.sin(lat2))
        C = np.cos(lat1) ** 2 + 2.0 * n * np.sin(lat1)
        lat0 = 0.5 * (lo + hi)
        rho0 = np.sqrt(max(C - 2.0 * n * np.sin(lat0), 0.0)) / n

        def fwd(a, e):
            rho = np.sqrt(np.maximum(C - 2.0 * n * np.sin(e), 0.0)) / n
            return (
                rho * np.sin(n * (a - l0)),
                rho0 - rho * np.cos(n * (a - l0)),
                np.ones_like(a, bool),
            )

        def inv(X, Y):
            rho_n = np.sqrt(X * X + (rho0 - Y) ** 2) * n
            e = np.arcsin(np.clip((C - rho_n * rho_n) / (2.0 * n), -1, 1))
            a = l0 + np.arctan2(X, rho0 - Y) / n
            return a, e

        return fwd, inv
    if m == "stereographic":
        # centered at (p1=0, l0); k = 2R/(1+cos e cos Δ) (projection.cc:785-830)
        def fwd(a, e):
            da = a - l0
            den = 1.0 + np.cos(e) * np.cos(da)
            k = 2.0 * d / np.maximum(den, 1e-9)
            return k * np.cos(e) * np.sin(da), k * np.sin(e), den > 1e-6

        def inv(X, Y):
            rho = np.sqrt(X * X + Y * Y)
            ce = 2.0 * np.arctan2(0.5 * rho, d)
            e = np.arcsin(np.clip(np.where(rho > 0, Y * np.sin(ce) / np.maximum(rho, 1e-12), 0.0), -1, 1))
            a = l0 + np.arctan2(X * np.sin(ce), rho * np.cos(ce))
            return a, e

        return fwd, inv
    if m == "rectilinear":
        # gnomonic, single image centered at l0 (projection.cc:684-731)
        def fwd(a, e):
            da = a - l0
            cosc = np.cos(e) * np.cos(da)
            ok = cosc > 0.05  # front hemisphere only
            c = np.maximum(cosc, 0.05)
            return np.cos(e) * np.sin(da) / c, np.sin(e) / c, ok

        def inv(X, Y):
            rho = np.sqrt(X * X + Y * Y)
            c = np.arctan(rho)
            e = np.arcsin(np.clip(np.where(rho > 0, Y * np.sin(c) / np.maximum(rho, 1e-12), 0.0), -1, 1))
            a = l0 + np.arctan2(X * np.sin(c), rho * np.cos(c))
            return a, e

        return fwd, inv
    if m == "pannini":
        # d-parametrized Pannini at p1=0 (projection.cc:735-783):
        # S = (d+1)/(d + cos Δ), X = S sin Δ, Y = S tan e
        def fwd(a, e):
            da = a - l0
            den = d + np.cos(da)
            ok = den > 1e-6
            S = (d + 1.0) / np.maximum(den, 1e-6)
            return S * np.sin(da), S * np.tan(np.clip(e, lo, hi)), ok

        def inv(X, Y):
            # X(d + cos Δ) = (d+1) sin Δ  →  Δ = asin(kd/√(1+k²)) + atan k
            k = X / (d + 1.0)
            da = np.arcsin(np.clip(k * d / np.sqrt(1.0 + k * k), -1, 1)) + np.arctan(k)
            S = (d + 1.0) / (d + np.cos(da))
            return l0 + da, np.arctan(Y / S)

        return fwd, inv
    if m == "azimuthal":
        # Lambert azimuthal equal-area at p1=0 (projection.cc recover :402-411)
        def fwd(a, e):
            da = a - l0
            den = 1.0 + np.cos(e) * np.cos(da)
            ok = den > 1e-6
            k = np.sqrt(2.0 / np.maximum(den, 1e-6))
            return k * np.cos(e) * np.sin(da), k * np.sin(e), ok

        def inv(X, Y):
            rho = np.sqrt(X * X + Y * Y)
            ce = 2.0 * np.arcsin(np.clip(0.5 * rho, -1, 1))
            e = np.arcsin(np.clip(np.where(rho > 0, Y * np.sin(ce) / np.maximum(rho, 1e-12), 0.0), -1, 1))
            a = l0 + np.arctan2(X * np.sin(ce), rho * np.cos(ce))
            return a, e

        return fwd, inv
    raise ValueError(f"unknown method {m!r}; known {METHODS}")


def _plane_bounds(p: PanoramaParams, fwd) -> tuple[float, float, float, float]:
    """Sample the FOV boundary to find the projection-plane extent
    (replaces the reference's per-method closed-form min/max blocks)."""
    na = np.linspace(p.min_h_angle, p.max_h_angle, 181)
    ne = np.linspace(p.min_v_angle, p.max_v_angle, 91)
    edge_a = np.concatenate([na, na, np.full_like(ne, p.min_h_angle), np.full_like(ne, p.max_h_angle)])
    edge_e = np.concatenate([np.full_like(na, p.min_v_angle), np.full_like(na, p.max_v_angle), ne, ne])
    X, Y, ok = fwd(edge_a, edge_e)
    X, Y = X[ok], Y[ok]
    return float(X.min()), float(X.max()), float(Y.min()), float(Y.max())


@dataclasses.dataclass
class Panorama:
    range: np.ndarray  # [H, W] f32, 0 where empty
    index: np.ndarray  # [H, W] int32 source point index, -1 empty
    reflectance: np.ndarray | None  # [H, W] f32 or None
    params: PanoramaParams

    def to_image(self) -> np.ndarray:
        """Range normalized to uint8 (ref getRangeImage -> png)."""
        r = self.range
        top = r.max() if r.max() > 0 else 1.0
        return (np.clip(r / top, 0, 1) * 255).astype(np.uint8)

    def back_project(self, uv: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Pixel coords [K, 2] (x, y) -> source point indices + valid
        mask (for matching features back to 3D)."""
        x = np.clip(np.round(uv[:, 0]).astype(int), 0, self.params.width - 1)
        y = np.clip(np.round(uv[:, 1]).astype(int), 0, self.params.height - 1)
        idx = self.index[y, x]
        return idx, idx >= 0


def project_panorama(
    points: np.ndarray,
    params: PanoramaParams | None = None,
    reflectance: np.ndarray | None = None,
) -> Panorama:
    """Project local-frame scan points to a panorama.

    Angle conventions follow the reference's cartesianToPolar remap
    (projection.cc:555-575): azimuth around the y (up) axis, elevation
    from the horizontal plane.  Nearest-point-wins z-buffering via a
    far-to-near sorted scatter.
    """
    params = params or PanoramaParams()
    pts = np.asarray(points, np.float64)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r = np.linalg.norm(pts, axis=1)
    valid = r > 1e-9
    if params.max_range is not None:
        valid &= r <= params.max_range
    azim = np.arctan2(x, z)  # [-pi, pi]
    elev = np.arcsin(np.clip(y / np.maximum(r, 1e-12), -1, 1))
    valid &= (elev >= params.min_v_angle) & (elev <= params.max_v_angle)
    valid &= (azim >= params.min_h_angle) & (azim <= params.max_h_angle)

    fwd, _ = _projection_pair(params)
    X, Y, ok = fwd(azim, elev)
    valid &= ok
    x0, x1, y0, y1 = _plane_bounds(params, fwd)
    W, H = params.width, params.height
    u = (X - x0) / max(x1 - x0, 1e-12) * (W - 1)
    v = (1.0 - (Y - y0) / max(y1 - y0, 1e-12)) * (H - 1)  # top = max Y

    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    valid &= (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    pix = np.clip(vi, 0, H - 1) * W + np.clip(ui, 0, W - 1)

    rng_img = np.zeros(H * W, np.float32)
    idx_img = np.full(H * W, -1, np.int32)
    refl_img = np.zeros(H * W, np.float32) if reflectance is not None else None

    sel = np.where(valid)[0]
    order = sel[np.argsort(-r[sel], kind="stable")]  # far first, near wins
    rng_img[pix[order]] = r[order].astype(np.float32)
    idx_img[pix[order]] = order.astype(np.int32)
    if refl_img is not None:
        refl_img[pix[order]] = np.asarray(reflectance)[order]

    return Panorama(
        range=rng_img.reshape(H, W),
        index=idx_img.reshape(H, W),
        reflectance=refl_img.reshape(H, W) if refl_img is not None else None,
        params=params,
    )


def point_pixels(
    points: np.ndarray, params: PanoramaParams
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pixel coordinates (ui, vi, valid) of each point under the
    panorama mapping — the forward half of project_panorama without the
    z-buffer (used by range-image normal estimation to sample per-point
    image values)."""
    pts = np.asarray(points, np.float64)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r = np.linalg.norm(pts, axis=1)
    valid = r > 1e-9
    if params.max_range is not None:
        valid &= r <= params.max_range
    azim = np.arctan2(x, z)
    elev = np.arcsin(np.clip(y / np.maximum(r, 1e-12), -1, 1))
    valid &= (elev >= params.min_v_angle) & (elev <= params.max_v_angle)
    valid &= (azim >= params.min_h_angle) & (azim <= params.max_h_angle)
    fwd, _ = _projection_pair(params)
    X, Y, ok = fwd(azim, elev)
    valid &= ok
    x0, x1, y0, y1 = _plane_bounds(params, fwd)
    W, H = params.width, params.height
    u = (X - x0) / max(x1 - x0, 1e-12) * (W - 1)
    v = (1.0 - (Y - y0) / max(y1 - y0, 1e-12)) * (H - 1)
    ui = np.clip(np.round(u).astype(np.int64), 0, W - 1)
    vi = np.clip(np.round(v).astype(np.int64), 0, H - 1)
    return ui, vi, valid


def recover_point_cloud(
    range_img: np.ndarray,
    params: PanoramaParams,
    reflectance_img: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Inverse-project a range image back to 3D points (ref
    projection.cc:332-460 recoverPointCloud).  Returns ([K,3] points,
    [K] reflectance or None); empty (range 0) pixels are skipped."""
    H, W = range_img.shape
    fwd, inv = _projection_pair(params)
    x0, x1, y0, y1 = _plane_bounds(params, fwd)
    vi, ui = np.nonzero(range_img > 0)
    r = np.asarray(range_img, np.float64)[vi, ui]
    X = x0 + (ui + 0.5) / W * (x1 - x0)
    Y = y1 - (vi + 0.5) / H * (y1 - y0)
    azim, elev = inv(X, Y)
    ce = np.cos(elev)
    pts = np.stack([ce * np.sin(azim), np.sin(elev), ce * np.cos(azim)], axis=1) * r[:, None]
    refl = (
        np.asarray(reflectance_img, np.float64)[vi, ui]
        if reflectance_img is not None
        else None
    )
    return pts, refl


def _resize_nearest(img: np.ndarray, scale: float) -> np.ndarray:
    H, W = img.shape
    h, w = max(1, int(round(H * scale))), max(1, int(round(W * scale)))
    vi = np.minimum((np.arange(h) / scale).astype(np.int64), H - 1)
    ui = np.minimum((np.arange(w) / scale).astype(np.int64), W - 1)
    return img[vi][:, ui]


def _resize_bilinear(img: np.ndarray, scale: float) -> np.ndarray:
    H, W = img.shape
    h, w = max(1, int(round(H * scale))), max(1, int(round(W * scale)))
    fy = np.clip((np.arange(h) + 0.5) / scale - 0.5, 0, H - 1)
    fx = np.clip((np.arange(w) + 0.5) / scale - 0.5, 0, W - 1)
    y0 = np.floor(fy).astype(np.int64)
    x0 = np.floor(fx).astype(np.int64)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (fy - y0)[:, None]
    wx = (fx - x0)[None, :]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    dd = img[y1][:, x1]
    return (
        a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + dd * wy * wx
    )


def reduce_range(
    points: np.ndarray,
    params: PanoramaParams,
    scale: float = 0.5,
    reflectance: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray | None]:
    """scan_red RANGE: panorama range image, nearest-neighbor downscale,
    recover (ref scan_red.cc reduce_range: INTER_NEAREST resize)."""
    pan = project_panorama(points, params, reflectance)
    small = _resize_nearest(pan.range, scale)
    refl = _resize_nearest(pan.reflectance, scale) if pan.reflectance is not None else None
    sp = dataclasses.replace(params, width=small.shape[1], height=small.shape[0])
    return recover_point_cloud(small, sp, refl)


def reduce_interpolate(
    points: np.ndarray,
    params: PanoramaParams,
    scale: float = 0.5,
    reflectance: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray | None]:
    """scan_red INTERPOLATE: bilinear resample of the range image before
    recovery (ref scan_red.cc reduce_interpolation: INTER_LINEAR).
    Bilinear blending across empty (0) pixels would invent midair points,
    so interpolation only blends where all four taps are occupied."""
    pan = project_panorama(points, params, reflectance)
    lin = _resize_bilinear(pan.range, scale)
    occ = _resize_bilinear((pan.range > 0).astype(np.float64), scale)
    near = _resize_nearest(pan.range, scale)
    small = np.where(occ >= 0.999, lin, np.where(near > 0, near, 0.0))
    refl = None
    if pan.reflectance is not None:
        rl = _resize_bilinear(pan.reflectance, scale)
        rn = _resize_nearest(pan.reflectance, scale)
        refl = np.where(occ >= 0.999, rl, rn)
    sp = dataclasses.replace(params, width=small.shape[1], height=small.shape[0])
    return recover_point_cloud(small, sp, refl)
