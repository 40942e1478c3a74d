"""Interior building model — the port of ``tpu3dtk.models.building``
(ref src/model/: plane3d/labeledPlane3d label detected planes as
walls/floor/ceiling, candidateOpening.cc finds door/window openings as
empty regions in each wall's occupancy image, model.cc assembles the
cleaned model).

Plane labelling and the plane bases are host f64; each wall's
occupancy image is one 2D histogram of its inliers in plane coordinates,
computed in f64 on the device over the whole cloud (an ``index_put_`` of
the occupied cells); opening detection stays on the host (small images):
connected components of the interior empty mask (``scipy.ndimage``) with
rectangle fits and the reference's size/fill-ratio gates
(candidateOpening's hand-crafted SVM features reduce to these geometric
gates without the learned classifier).  ``build_model`` runs the port's
Hough planes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .shapes import HoughParams, Plane, detect_planes

__all__ = [
    "label_planes",
    "wall_occupancy",
    "detect_openings",
    "build_model",
    "Opening",
]


@dataclasses.dataclass(frozen=True)
class Opening:
    """A door/window candidate on a wall (candidateOpening.cc)."""

    lo: np.ndarray       # [2] plane coordinates (cm)
    hi: np.ndarray       # [2]
    center3d: np.ndarray  # [3] world
    fill: float           # occupied fraction inside the rectangle
    kind: str             # "door" | "window"


def label_planes(planes: list[Plane], up=(0.0, 1.0, 0.0),
                 tol_deg: float = 15.0) -> dict:
    """Split planes into walls / floors / ceilings by normal direction
    (labeledPlane3d role)."""
    up = np.asarray(up, np.float64)
    out = {"walls": [], "floors": [], "ceilings": [], "other": []}
    cos_tol = np.cos(np.deg2rad(tol_deg))
    med_h = np.median([q.center @ up for q in planes]) if planes else 0.0
    for p in planes:
        c = float(np.dot(p.normal, up))
        if abs(c) >= cos_tol:
            # horizontal: floor vs ceiling by inlier-centroid height
            key = "floors" if (p.center @ up) < med_h else "ceilings"
            out[key].append(p)
        elif abs(c) <= np.sin(np.deg2rad(tol_deg)):
            out["walls"].append(p)
        else:
            out["other"].append(p)
    return out


def _plane_basis(normal):
    n = np.asarray(normal, np.float64)
    a = np.array([0.0, 1.0, 0.0])
    if abs(n @ a) > 0.9:
        a = np.array([1.0, 0.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    return u, v


def _points(points, device):
    if isinstance(points, torch.Tensor):
        return points.to(torch.float64)
    if device is None:
        from .. import default_device

        device = default_device()
    return torch.as_tensor(np.asarray(points), device=device).to(torch.float64)


def wall_occupancy(points, plane: Plane, dist_tol: float = 10.0,
                   cell: float = 5.0, device=None):
    """Occupancy image of a wall: inliers histogrammed in plane
    coordinates.  Returns (occ [H,W] bool, origin2d, (u, v) basis) as
    numpy; the histogram runs on the points' device (an array goes to
    ``device``; None: the first CUDA card)."""
    pts = _points(points, device)
    dev = pts.device
    d = pts @ torch.as_tensor(np.asarray(plane.normal, np.float64), device=dev) - plane.rho
    sel = pts[d.abs() < dist_tol]
    u, v = _plane_basis(plane.normal)
    uu = sel @ torch.as_tensor(u, device=dev)
    vv = sel @ torch.as_tensor(v, device=dev)
    lo = torch.stack([uu.min(), vv.min()]).cpu().numpy()
    top = torch.stack([uu.max(), vv.max()]).cpu().numpy()
    W = int(np.ceil((top[0] - lo[0]) / cell)) + 1
    H = int(np.ceil((top[1] - lo[1]) / cell)) + 1
    occ = torch.zeros((H, W), dtype=torch.bool, device=dev)
    xi = torch.clamp(((uu - lo[0]) / cell).to(torch.int64), 0, W - 1)
    yi = torch.clamp(((vv - lo[1]) / cell).to(torch.int64), 0, H - 1)
    occ[yi, xi] = True
    return occ.cpu().numpy(), lo, (u, v)


def detect_openings(
    occ: np.ndarray,
    origin2d,
    basis,
    plane: Plane,
    cell: float = 5.0,
    min_extent: float = 40.0,
    max_extent: float = 400.0,
    max_fill: float = 0.25,
    door_height: float = 170.0,
) -> list[Opening]:
    """Openings = connected empty regions INSIDE the wall footprint,
    gated by size and fill ratio (candidateOpening.cc geometry gates).
    A region reaching the wall's bottom edge is a door, else window."""
    from scipy import ndimage

    # close single-cell sampling holes so only REAL openings remain as
    # empty components (finite scan density leaves speckle at any cell
    # size; the reference's occupancy images do the same morphology)
    occ = ndimage.binary_closing(
        occ, structure=np.ones((3, 3), bool), border_value=1
    )
    # interior = between first/last occupied cell per row and column
    H, W = occ.shape
    col_any = occ.any(axis=0)
    row_any = occ.any(axis=1)
    if not col_any.any() or not row_any.any():
        return []
    x0, x1 = np.argmax(col_any), W - 1 - np.argmax(col_any[::-1])
    y0, y1 = np.argmax(row_any), H - 1 - np.argmax(row_any[::-1])
    interior = np.zeros_like(occ)
    interior[y0 : y1 + 1, x0 : x1 + 1] = True
    empty = interior & ~occ
    labels, n = ndimage.label(empty)
    out: list[Opening] = []
    u, v = basis
    for k in range(1, n + 1):
        ys, xs = np.nonzero(labels == k)
        lo2 = np.array([xs.min(), ys.min()]) * cell + origin2d
        hi2 = (np.array([xs.max(), ys.max()]) + 1) * cell + origin2d
        ext = hi2 - lo2
        if ext.min() < min_extent or ext.max() > max_extent:
            continue
        rect_cells = (xs.max() - xs.min() + 1) * (ys.max() - ys.min() + 1)
        region = occ[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
        fill = float(region.sum()) / max(rect_cells, 1)
        if fill > max_fill:
            continue
        touches_bottom = ys.min() <= y0 + 1
        kind = (
            "door"
            if touches_bottom and ext[1] >= door_height * 0.8
            else "window"
        )
        mid = 0.5 * (lo2 + hi2)
        center3d = plane.normal * plane.rho + u * mid[0] + v * mid[1]
        out.append(
            Opening(
                lo=lo2, hi=hi2, center3d=center3d, fill=fill, kind=kind
            )
        )
    return out


def build_model(points, hough: HoughParams | None = None,
                cell: float = 5.0, device=None) -> dict:
    """Full pipeline (model.cc): detect planes → label → per-wall
    occupancy → openings.  Returns {'walls', 'floors', 'ceilings',
    'openings': {wall_index: [Opening]}}.  Runs on the points' device
    (an array goes to ``device``; None: the first CUDA card)."""
    pts = _points(points, device)
    planes = detect_planes(pts, hough)
    labeled = label_planes(planes)
    openings = {}
    for wi, wall in enumerate(labeled["walls"]):
        occ, lo, basis = wall_occupancy(pts, wall, cell=cell)
        ops = detect_openings(occ, lo, basis, wall, cell=cell)
        if ops:
            openings[wi] = ops
    labeled["openings"] = openings
    return labeled
