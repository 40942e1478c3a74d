"""Cylinder detection — the port of ``tpu3dtk.models.cylinder`` (ref
src/detectCylinder/: Hough axis detection over the normal sphere +
circle estimation in the projected plane; SURVEY §2.6).

Two stages, as in the reference:
1. **Axis**: a cylinder's surface normals are perpendicular to its
   axis, so the axis direction maximizes the count of normals with
   |n·d| ≈ 0.  The vote ``|N @ D^T| < axis_tol`` runs in f64 on the
   device, a tile of points at a time (``[tile, D]``), elementwise, so no
   TF32 matmul can round it.
2. **Circle**: project the candidates onto the plane ⊥ axis and fit the
   circle (algebraic Kasa fit inside RANSAC), then collect inliers on
   the cylinder shell.  The RANSAC triples are the JAX package's
   ``default_rng(0).choice`` draws, all drawn first in its order (one
   draw an iteration, whatever it finds); the Kasa fits are numpy
   ``lstsq`` on the host, as there; the inlier counts of every
   hypothesis are one batched f64 pass on the device, and the first best
   wins, as the sequential strict ``>`` picks it.  Hypotheses the JAX
   loop skips (not finite, r ≤ 0, r > 1e4) are masked, not dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["CylinderParams", "Cylinder", "detect_cylinders"]

# [tile, D] f64 elements a vote tile, and [H, tile] a RANSAC count tile:
# 2^25 on a card, 2^20 on the CPU
_TILE = {"cuda": 1 << 25, "cpu": 1 << 20}


@dataclasses.dataclass(frozen=True)
class Cylinder:
    axis: np.ndarray  # [3] unit
    center: np.ndarray  # [3] point on the axis
    radius: float
    n_inliers: int


@dataclasses.dataclass
class CylinderParams:
    n_directions: int = 500
    axis_tol: float = 0.15  # |n.d| below this counts as perpendicular
    shell_tol: float = 5.0  # distance band around the shell (cm)
    min_inliers: int = 100
    max_cylinders: int = 5
    ransac_iters: int = 200
    knn: int = 16


def _fib_sphere(n: int) -> np.ndarray:
    k = np.arange(n) + 0.5
    z = 1.0 - k / n  # half sphere (axes are unsigned)
    phi = k * (np.pi * (3.0 - np.sqrt(5.0)))
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def _kasa_circle(xy: np.ndarray):
    """Algebraic circle fit: minimizes |x|^2 - 2 c.x + (|c|^2 - r^2)."""
    A = np.column_stack([2 * xy, np.ones(len(xy))])
    b = (xy**2).sum(1)
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    c = sol[:2]
    r2 = sol[2] + c @ c
    return c, float(np.sqrt(max(r2, 0.0)))


def _perp(N, dirs_t, tol):
    """|N @ D^T| < tol for f64 normals [n,3] and directions [D,3],
    elementwise."""
    dT = dirs_t.T
    s = N[:, 0:1] * dT[0]
    s = s + N[:, 1:2] * dT[1]
    s = s + N[:, 2:3] * dT[2]
    return s.abs() < tol


def _axis_votes(N, dirs_t, tol, tile):
    votes = torch.zeros(dirs_t.shape[0], dtype=torch.int64, device=N.device)
    step = max(1, tile // dirs_t.shape[0])
    for a in range(0, N.shape[0], step):
        votes += _perp(N[a : a + step], dirs_t, tol).sum(0)
    return votes


def _shell_res(xy, c, r):
    """|‖xy − c‖ − r| for points xy [n,2] and circles c [H,2], r [H]:
    [H, n] f64."""
    dx = xy[None, :, 0] - c[:, 0:1]
    dy = xy[None, :, 1] - c[:, 1:2]
    return (torch.sqrt(dx * dx + dy * dy) - r[:, None]).abs()


def _ransac_circle(xy, xy_host, rng, params: CylinderParams, tile):
    """The JAX package's RANSAC over ``params.ransac_iters`` triples:
    returns the best hypothesis's inlier mask [n] (a tensor) or None."""
    n = xy.shape[0]
    sels = [rng.choice(n, 3, replace=False) for _ in range(params.ransac_iters)]
    fits = [_kasa_circle(xy_host[sel]) for sel in sels]
    ok = np.array([np.isfinite(r) and 0 < r <= 1e4 for _c, r in fits])
    if not ok.any():
        return None
    c = torch.as_tensor(np.stack([f[0] for f in fits]), device=xy.device)
    r = torch.as_tensor(np.array([f[1] for f in fits]), device=xy.device)
    counts = torch.zeros(len(fits), dtype=torch.int64, device=xy.device)
    step = max(1, tile // len(fits))
    for a in range(0, n, step):
        counts += (_shell_res(xy[a : a + step], c, r) < params.shell_tol).sum(1)
    counts = torch.where(torch.as_tensor(ok, device=xy.device), counts, -1)
    best = int(torch.argmax(counts))  # the first best, as the strict ">" keeps it
    return _shell_res(xy, c[best : best + 1], r[best : best + 1])[0] < params.shell_tol


def detect_cylinders(points, normals=None, params: CylinderParams | None = None, device=None):
    """Detect up to max_cylinders; returns list[Cylinder].  ``points``
    [N,3] (and ``normals``) as arrays or tensors; the work runs on their
    device (an array goes to ``device``; None: the first CUDA card)."""
    from ..ops import normals as normals_ops

    params = params or CylinderParams()
    if isinstance(points, torch.Tensor):
        dev = points.device
    elif device is None:
        from .. import default_device

        dev = default_device()
    else:
        dev = torch.device(device)
    pts = torch.as_tensor(points, device=dev).to(torch.float64)
    tile = _TILE.get(dev.type, 1 << 20)
    if normals is None:
        vp = pts.mean(0).cpu().numpy() + np.array([0.0, 1e4, 0.0])
        normals = normals_ops.estimate_normals_knn(
            pts.to(torch.float32),
            torch.ones(pts.shape[0], dtype=torch.bool, device=dev),
            torch.as_tensor(vp.astype(np.float32), device=dev),
            k=params.knn,
        )
    nrm = torch.as_tensor(normals, device=dev).to(torch.float64)

    rng = np.random.default_rng(0)
    out: list[Cylinder] = []
    remaining = torch.arange(pts.shape[0], device=dev)
    dirs = _fib_sphere(params.n_directions)
    dirs_t = torch.as_tensor(dirs, device=dev)
    for _ in range(params.max_cylinders):
        if remaining.shape[0] < params.min_inliers:
            break
        P = pts[remaining]
        N = nrm[remaining]
        votes = _axis_votes(N, dirs_t, params.axis_tol, tile)
        d_idx = int(torch.argmax(votes))
        if int(votes[d_idx]) < params.min_inliers:
            break
        axis = dirs[d_idx]
        cand = _perp(N, dirs_t[d_idx : d_idx + 1], params.axis_tol)[:, 0]
        # project candidates onto the plane perpendicular to axis
        u = np.linalg.svd(np.eye(3) - np.outer(axis, axis))[0][:, :2]
        u_t = torch.as_tensor(u, device=dev)
        xy = P[cand] @ u_t
        if xy.shape[0] < params.min_inliers:
            break
        xy_host = xy.cpu().numpy()
        best_inl = _ransac_circle(xy, xy_host, rng, params, tile)
        if best_inl is None or int(best_inl.sum()) < params.min_inliers:
            remaining = remaining[~cand]
            continue
        c, r = _kasa_circle(xy_host[best_inl.cpu().numpy()])
        # final shell inliers over ALL remaining points
        xy_all = P @ u_t
        c_t = torch.as_tensor(c[None], device=dev)
        shell = _shell_res(xy_all, c_t, torch.as_tensor([r], device=dev))[0] < params.shell_tol
        n_shell = int(shell.sum())
        if n_shell < params.min_inliers:
            remaining = remaining[~cand]
            continue
        axis_t = torch.as_tensor(axis, device=dev)
        center3 = u @ c + axis * float((P[shell] @ axis_t).mean())
        out.append(
            Cylinder(axis=axis, center=center3, radius=r, n_inliers=n_shell)
        )
        remaining = remaining[~shell]
    return out
