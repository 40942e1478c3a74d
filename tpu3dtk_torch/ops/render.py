"""Offscreen point-cloud rendering — the port of ``tpu3dtk.ops.render``
(the reference viewer's drawing core, ``src/show/show_gl.cc:32``
DrawPoints / ``show_common.cc:678`` display pipeline).

The reference walks its octrees and issues GL vertex arrays; the
capability it gives (inspect registered clouds, replay ``.frames``
animations, cull by view) is a data-parallel z-buffer splat: one pinhole
projection over all points, a scatter-min depth pass, and a tie-broken
colour scatter.  :func:`render_points` runs it in torch on the points'
device; the host only encodes PNGs (``io.png``).  The camera poses, the
colour ramps and the frustum-culled LOD cut (:func:`lod_select`) are host
numpy, as in the JAX package.

Conventions: the camera looks down +z in its own frame, pose = [4,4]
camera-to-world like scan poses, fov is the vertical field of view in
degrees.

Rounding: a point's pixel is ``floor`` of its projection, so one ulp
moves a point across a pixel edge.  The projection is elementwise in a
fixed order and rounds as XLA does in the JAX package (the rotation as a
chain of fused multiply-adds, the pixel coordinate as one more,
``math3d.fma_f32``), so the pixels and depths equal the JAX package's.
The packed colours are int64: torch has no uint32 scatter on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.math3d import fma_f32
from .octree import _compact3

__all__ = [
    "color_by_depth",
    "color_by_height",
    "color_by_scan",
    "color_by_value",
    "lod_select",
    "look_at",
    "orbit_pose",
    "render_points",
]

_FAR = 3.4e38  # an empty pixel's depth before it is reported as NaN


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """Camera-to-world pose [4,4] with +z from eye toward target
    (numpy, host-side — poses are tiny)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-30)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    n = np.linalg.norm(right)
    if n < 1e-9:  # fwd parallel to up: pick another up
        up = np.array([1.0, 0.0, 0.0])
        right = np.cross(up, fwd)
        n = np.linalg.norm(right)
    right /= n
    true_up = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0] = right
    T[:3, 1] = true_up
    T[:3, 2] = fwd
    T[:3, 3] = eye
    return T


def orbit_pose(center, radius, azimuth_deg, elevation_deg=20.0):
    """Orbit camera pose around ``center`` (show's cam path role)."""
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    eye = np.asarray(center, np.float64) + radius * np.array(
        [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)]
    )
    return look_at(eye, center)


def color_by_height(points, lo=None, hi=None):
    """uint8 [N,3] turbo-like height ramp on the y (up) coordinate."""
    y = np.asarray(points)[:, 1].astype(np.float64)
    lo = np.min(y) if lo is None else lo
    hi = np.max(y) if hi is None else hi
    t = np.clip((y - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(2.0 * t - 1.5), 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * t - 1.0), 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * t - 0.5), 0, 1)
    return (np.stack([r, g, b], 1) * 255).astype(np.uint8)


def color_by_value(values, lo=None, hi=None):
    """Scalar channel -> warm colormap (the reference colormanager's
    reflectance/amplitude ramps, src/show/colormanager.cc)."""
    v = np.asarray(values, np.float64)
    lo = np.percentile(v, 2) if lo is None else lo
    hi = np.percentile(v, 98) if hi is None else hi
    t = np.clip((v - lo) / max(hi - lo, 1e-9), 0, 1)
    r = np.clip(1.5 * t, 0, 1)
    g = np.clip(1.5 * (t - 0.33), 0, 1)
    b = np.clip(1.5 * (t - 0.66), 0, 1)
    return (np.stack([r, g, b], 1) * 255).astype(np.uint8)


def color_by_scan(counts):
    """One distinct color per scan index (colormanager colorScanVal):
    counts[i] points of scan i, concatenated."""
    palette = np.array([
        [230, 60, 60], [60, 180, 60], [70, 110, 240], [230, 200, 50],
        [200, 70, 200], [70, 210, 210], [240, 140, 40], [150, 150, 150],
    ], np.uint8)
    out = np.concatenate([
        np.tile(palette[i % len(palette)], (c, 1))
        for i, c in enumerate(counts)
    ]) if len(counts) else np.zeros((0, 3), np.uint8)
    return out


def color_by_depth(depth_img, near, far):
    """Map a rendered [H,W] depth image to uint8 grayscale."""
    d = np.asarray(depth_img, np.float64)
    t = np.clip((d - near) / max(far - near, 1e-9), 0.0, 1.0)
    t = np.where(np.isfinite(d), 1.0 - t, 0.0)
    g = (t * 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _project(pts, view_inv, fov_scale: float, width: int, height: int):
    """Camera-frame depth z and pixel coordinates (u, v) of world points
    [N,3] f32, rounded as the JAX package's XLA program rounds them: each
    camera coordinate a chain of fused multiply-adds over x, y, z plus the
    translation, the pixel coordinate one fused multiply-add."""
    R, t = view_inv[:3, :3], view_inv[:3, 3]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]

    def row(i):
        acc = fma_f32(y, R[i, 1].expand_as(y), x * R[i, 0])
        return fma_f32(z, R[i, 2].expand_as(z), acc) + t[i]

    cx, cy, cz = row(0), row(1), row(2)
    zs = torch.clamp(cz, min=float(np.float32(1e-6)))
    f = torch.full_like(zs, float(np.float32(np.float32(fov_scale) * np.float32(height)) / np.float32(2.0)))
    u = fma_f32(cx / zs, f, torch.full_like(zs, width / 2.0))
    v = fma_f32(-cy / zs, f, torch.full_like(zs, height / 2.0))
    return cz, u, v


def _render(pts_w, colors_packed, view_inv, fov_scale: float, near: float,
            width: int, height: int, point_size: int):
    """Project + z-buffer scatter-min + tie-broken colour scatter-max on
    the points' device.  pts_w [N,3] f32 world points; colors_packed [N]
    int64 0xRRGGBB; view_inv [4,4] f32 world-to-camera.  Returns (rgb
    [H,W,3] uint8, depth [H,W] f32 with NaN where empty) tensors."""
    z, u, v = _project(pts_w, view_inv, fov_scale, width, height)
    # floor(u) in [0, W) iff u in [0, W): tested on the floats, so no
    # off-screen coordinate is ever converted to an integer
    ok = (z > float(np.float32(near))) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    ui = torch.where(ok, torch.floor(u), 0.0).to(torch.int64)
    vi = torch.where(ok, torch.floor(v), 0.0).to(torch.int64)

    npx = height * width  # slot npx is the dump slot
    r = (point_size - 1) // 2
    offs = [(dy, dx) for dy in range(-r, point_size - r) for dx in range(-r, point_size - r)]

    def idx_of(dy, dx):
        uu = torch.clamp(ui + dx, 0, width - 1)
        vv = torch.clamp(vi + dy, 0, height - 1)
        return torch.where(ok, vv * width + uu, npx)

    zb = torch.full((npx + 1,), _FAR, dtype=torch.float32, device=pts_w.device)
    for dy, dx in offs:
        zb.scatter_reduce_(0, idx_of(dy, dx), z, "amin")
    # colour pass: a point wins a pixel iff its z equals the buffer's
    # minimum; ties go to the largest packed colour
    cb = torch.zeros(npx + 1, dtype=torch.int64, device=pts_w.device)
    for dy, dx in offs:
        idx = idx_of(dy, dx)
        win = ok & (z <= zb[idx])
        cb.scatter_reduce_(0, torch.where(win, idx, npx), colors_packed, "amax")
    cb = cb[:npx].view(height, width)
    img = torch.stack([(cb >> 16) & 0xFF, (cb >> 8) & 0xFF, cb & 0xFF], dim=-1).to(torch.uint8)
    zbuf = zb[:npx].view(height, width)
    return img, torch.where(zbuf < _FAR, zbuf, float("nan"))


def render_points(
    points,
    pose,
    colors=None,
    width: int = 960,
    height: int = 720,
    fov_deg: float = 60.0,
    near: float = 1.0,
    point_size: int = 1,
    device=None,
):
    """Render world-frame ``points`` [N,3] (array or tensor) from camera
    ``pose`` [4,4] (camera-to-world) on the points' device (a tensor's
    own; an array goes to ``device``, None: the first CUDA card).
    Returns numpy (rgb [H,W,3] uint8, depth [H,W] f32, NaN where empty).
    ``colors``: uint8 [N,3] (default height ramp)."""
    if isinstance(points, torch.Tensor):
        dev = points.device
        pts = points.to(torch.float32)
    else:
        if device is None:
            from .. import default_device

            device = default_device()
        dev = torch.device(device)
        pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    if colors is None:
        colors = color_by_height(pts.cpu().numpy())
    c = torch.as_tensor(np.asarray(colors), device=dev).to(torch.int64)
    packed = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
    Tinv = np.linalg.inv(np.asarray(pose, np.float64)).astype(np.float32)
    fov_scale = float(np.float32(1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)))
    img, depth = _render(
        pts.contiguous(), packed, torch.as_tensor(Tinv, device=dev), fov_scale,
        near, int(width), int(height), int(point_size),
    )
    return img.cpu().numpy(), depth.cpu().numpy()


# ---------------------------------------------------------------------------
# Frustum-culled LOD selection over the Morton octree
# ---------------------------------------------------------------------------
#
# The reference viewer renders city-scale clouds through its serialized
# octrees with view culling and per-frame point budgets
# (Show_BOctTree::displayOctTreeCulledLOD, include/show/show_Boctree.h:
# 504-561; frustum tests src/show/viewcull.cc:109-799).  As in the JAX
# package, the LinearOctree's LEVELS are walked instead of pointers: at
# each level every occupied node is one row of a vectorized
# sphere-frustum test + projected-size test; small-on-screen nodes emit
# one representative, surviving nodes refine to the next level, and the
# remaining budget caps the depth of the cut.  Host numpy.


def _frustum_planes(fov_scale: float, aspect: float):
    """Inward normals of the 5 frustum planes in camera space
    (near plane handled by the z test).  Camera looks along +z."""
    sx = fov_scale            # x_ndc = x * sx / z
    sy = fov_scale * aspect   # y_ndc = y * sy / z
    planes = np.array([
        [sx, 0.0, 1.0],    # left   (x*sx + z >= 0)
        [-sx, 0.0, 1.0],   # right
        [0.0, sy, 1.0],    # bottom
        [0.0, -sy, 1.0],   # top
        [0.0, 0.0, 1.0],   # near-ish (z >= 0)
    ])
    return planes / np.linalg.norm(planes, axis=1, keepdims=True)


def lod_select(
    tree,
    pose,
    fov_deg: float = 60.0,
    width: int = 960,
    height: int = 720,
    budget: int = 1_000_000,
    min_pixels: float = 1.5,
    start_level: int = 4,
):
    """Select at most ~``budget`` display points for the given camera.

    Returns (points [K, 3], weights [K] — points per represented node).
    The cut emits a node when its voxel projects below ``min_pixels``
    on screen, when the leaf level is reached, or when refining further
    would exceed the budget.
    """
    pose = np.asarray(pose, np.float64)
    Rinv = pose[:3, :3].T
    t = pose[:3, 3]
    fov_scale = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    planes = _frustum_planes(fov_scale, width / height)
    half_diag = np.sqrt(3.0) / 2.0

    codes = tree.codes
    counts = tree.counts.astype(np.int64)
    alive = np.ones(len(codes), bool)
    out_pts = []
    out_w = []
    depth = tree.depth

    for level in range(min(start_level, depth), depth + 1):
        if not alive.any():
            break
        shift = 3 * (depth - level)
        anc = codes[alive] >> shift
        uniq, inv = np.unique(anc, return_inverse=True)
        edge = tree.size / (1 << level)
        x = _compact3(uniq >> 2)
        y = _compact3(uniq >> 1)
        z = _compact3(uniq)
        centers = tree.origin + (np.stack([x, y, z], 1) + 0.5) * edge
        r = half_diag * edge
        cam = (centers - t) @ Rinv.T
        inside = np.ones(len(uniq), bool)
        for n in planes:
            inside &= cam @ n >= -r
        # projected voxel size in pixels (conservative: at near z)
        zc = np.maximum(cam[:, 2] - r, 1e-6)
        px = edge * fov_scale / zc * (width / 2.0)
        leafish = (px < min_pixels) | (level == depth)
        # budget check: refining all non-leafish nodes at least doubles
        # the node count; emit everything at this level when the next
        # level cannot fit
        n_emit_now = int(inside.sum())
        spent = sum(len(p) for p in out_pts)
        if level < depth:
            est_next = n_emit_now * 4
            if spent + est_next > budget:
                leafish = np.ones_like(leafish)
        emit = inside & leafish
        cnt_per_node = np.zeros(len(uniq), np.int64)
        np.add.at(cnt_per_node, inv, counts[alive])
        if emit.any():
            out_pts.append(centers[emit])
            out_w.append(cnt_per_node[emit])
        # leaves under culled or emitted nodes stop refining
        dead_node = ~inside | emit
        idx_alive = np.where(alive)[0]
        alive[idx_alive[dead_node[inv]]] = False
    if not out_pts:
        return np.zeros((0, 3)), np.zeros(0, np.int64)
    pts = np.concatenate(out_pts)
    w = np.concatenate(out_w)
    if len(pts) > budget:
        order = np.argsort(-w)[:budget]
        pts, w = pts[order], w[order]
    return pts, w
