"""Normal estimation — the port of ``tpu3dtk.ops.normals`` (the
reference's ``calculateNormals*`` family, src/slam6d/normals.cc:220-705).

Per point: PCA over a neighbourhood; the normal is the eigenvector of the
smallest eigenvalue of the neighbourhood covariance, flipped to face the
viewpoint (the scanner position), the reference's orientation rule.  The
symmetric 3x3 eigenproblem is solved in closed form (trigonometric
Cardano, then the largest cross product of the rows of A − λI), batched,
as in the JAX package.  Plain torch on the tensors' device: the JAX
package has no Pallas kernel here.

- :func:`estimate_normals_knn`: the k nearest (``ops.knn.knn_brute``).
- :func:`estimate_normals_adaptive_knn`: one ``[N, kmax]`` k-NN feeds
  every rung of a static k ladder; a point keeps the smallest k whose
  surface variation is below a threshold.
- :func:`estimate_normals_apx_knn`: neighbours searched in a random
  subset, drawn by ``np.random.default_rng(seed)`` on the host as in the
  JAX package (the same subset).
- :func:`estimate_normals_panorama`: the 3x3 pixel neighbourhood of a
  range image; projection, covariances and the per-point sampling are
  host numpy as in the JAX package, the eigenvectors run on the device.
- :func:`knn_pca_features`: k-NN normals and the surface variation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import knn as knn_ops

__all__ = [
    "estimate_normals_adaptive_knn", "estimate_normals_apx_knn", "estimate_normals_knn",
    "estimate_normals_panorama", "knn_pca_features",
    "smallest_eigenvector_sym3", "sym3_eigenvalues",
]


def _cardano(A):
    """(trace, q, p, phi) of the trigonometric solution of the
    characteristic cubic of symmetric (...,3,3) f32 A."""
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    q = tr / 3.0
    B = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p = torch.sqrt(torch.clamp((B * B).sum(dim=(-2, -1)) / 6.0, min=1e-30))
    r = torch.linalg.det(B) / torch.clamp(2.0 * p**3, min=1e-30)
    phi = torch.arccos(torch.clamp(r, -1.0, 1.0)) / 3.0
    return tr, q, p, phi


def sym3_eigenvalues(A):
    """The three eigenvalues of symmetric (...,3,3), ascending."""
    tr, q, p, phi = _cardano(A.to(torch.float32))
    l0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = q + 2.0 * p * torch.cos(phi)
    return torch.stack([l0, tr - l0 - l2, l2], dim=-1)


def smallest_eigenvector_sym3(A):
    """Unit eigenvector of the smallest eigenvalue of symmetric
    (...,3,3): the largest cross product of two rows of A − λ_min I (a
    robust rank-2 null space); +y for an isotropic neighbourhood."""
    A = A.to(torch.float32)
    _tr, q, p, phi = _cardano(A)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    M = A - lam_min[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack([
        torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2), torch.linalg.cross(r1, r2),
    ], dim=-2)
    best = (cands * cands).sum(-1).argmax(-1)
    v = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    norm = torch.sqrt((v * v).sum(-1, keepdim=True))
    fallback = torch.zeros_like(v)
    fallback[..., 1] = 1.0
    return torch.where(norm > 1e-12, v / torch.clamp(norm, min=1e-30), fallback)


def _upload(device, points, mask=None, viewpoint=None):
    """(points f32, mask bool, viewpoint f32) on one device: a tensor
    cloud keeps its device, an array goes to ``device`` (None: the
    package default, the first card).  No mask: every point; no
    viewpoint: the origin."""
    if isinstance(points, torch.Tensor):
        dev = points.device
    else:
        from .. import default_device

        dev = default_device() if device is None else torch.device(device)
        points = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    points = points.to(torch.float32)
    if mask is None:
        mask = torch.ones(points.shape[0], dtype=torch.bool, device=dev)
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    viewpoint = torch.as_tensor(viewpoint, device=dev).to(torch.float32)
    return points, mask, viewpoint


def _pca_cov(points, mask, idx):
    """Per-point neighbourhood covariance [N,3,3] from gathered k-NN
    indices [N,k]; masked neighbours carry weight 0."""
    nbrs = points[idx]  # [N, k, 3]
    w = mask[idx].to(torch.float32)[..., None]
    cnt = torch.clamp(w.sum(1), min=1.0)
    mean = (nbrs * w).sum(1) / cnt
    cen = (nbrs - mean[:, None, :]) * w
    return torch.einsum("nki,nkj->nij", cen, cen) / cnt[..., None]


def _face(n, points, mask, viewpoint):
    """Flip each normal toward the viewpoint; zero where masked out."""
    flip = (n * (viewpoint[None, :] - points)).sum(-1) < 0.0
    n = torch.where(flip[:, None], -n, n)
    return torch.where(mask[:, None], n, 0.0)


def _surface_variation(cov):
    lam = sym3_eigenvalues(cov)
    return lam[..., 0] / torch.clamp(lam[..., 0] + lam[..., 1] + lam[..., 2], min=1e-30)


def estimate_normals_knn(points, mask, viewpoint, k: int = 20, device=None):
    """Normals of a padded cloud from k-NN PCA.

    points [N,3], mask [N], viewpoint [3] (the scanner position in the
    points' frame): torch tensors (the work runs on their device) or
    numpy arrays (uploaded to ``device``; None: the package default,
    the first CUDA card).  Returns unit normals [N,3] f32 on that
    device, oriented toward the viewpoint, zero where masked out."""
    points, mask, viewpoint = _upload(device, points, mask, viewpoint)
    idx, _d2 = knn_ops.knn_brute(points, mask, points, mask, k)
    n = smallest_eigenvector_sym3(_pca_cov(points, mask, idx))
    return _face(n, points, mask, viewpoint)


def estimate_normals_adaptive_knn(points, mask, viewpoint, ks: tuple = (8, 16, 32, 64),
                                  flat_thresh: float = 0.02, device=None):
    """Adaptive-k normals (ref calculateNormalsAdaptiveKNN: grow the
    neighbourhood until the plane fit is reliable).  One ``[N, max(ks)]``
    k-NN feeds every rung; each point keeps the normal of the smallest k
    whose surface variation λ0/(λ0+λ1+λ2) is below ``flat_thresh``, else
    that of the largest.  Inputs and result as
    :func:`estimate_normals_knn`."""
    points, mask, viewpoint = _upload(device, points, mask, viewpoint)
    idx, _d2 = knn_ops.knn_brute(points, mask, points, mask, max(ks))
    chosen_n = chosen_ok = None
    for k in sorted(ks):
        cov = _pca_cov(points, mask, idx[:, :k])
        n_k = smallest_eigenvector_sym3(cov)
        ok = _surface_variation(cov) < flat_thresh
        if chosen_n is None:
            chosen_n, chosen_ok = n_k, ok
        else:
            chosen_n = torch.where((ok & ~chosen_ok)[:, None], n_k, chosen_n)
            chosen_ok = chosen_ok | ok
    # where no rung is flat enough: the largest k's normal (the last rung)
    n = torch.where(chosen_ok[:, None], chosen_n, n_k)
    return _face(n, points, mask, viewpoint)


def estimate_normals_apx_knn(points, mask, viewpoint, k: int = 20, subsample: int = 4,
                             seed: int = 0, device=None):
    """Approximate-k-NN normals (ref calculateNormalsApxKNN): the
    neighbours come from the points with ``rng.random(N) < 1/subsample``
    (``rng = np.random.default_rng(seed)``, the JAX package's draw).
    Inputs and result as :func:`estimate_normals_knn`."""
    points, mask, viewpoint = _upload(device, points, mask, viewpoint)
    rng = np.random.default_rng(seed)
    keep = rng.random(points.shape[0]) < (1.0 / max(subsample, 1))
    sub_mask = mask & torch.as_tensor(keep, device=points.device)
    idx, _d2 = knn_ops.knn_brute(points, mask, points, sub_mask, k)
    n = smallest_eigenvector_sym3(_pca_cov(points, sub_mask, idx))
    return _face(n, points, mask, viewpoint)


def _window_covariances(pts, params):
    """Covariance [H, W, 3, 3] f64 of the points of each pixel's 3x3
    window (``np.roll``: the image wraps at all four edges) of the
    panorama of ``pts`` [N,3] f64; host numpy, the JAX package's code."""
    from .panorama import project_panorama

    idx_img = project_panorama(pts, params).index  # [H, W] source point, -1 empty
    ok = idx_img >= 0
    pix_pts = pts[np.clip(idx_img, 0, None)] * ok[..., None]
    shifts = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    nb = np.stack([np.roll(np.roll(pix_pts, dy, 0), dx, 1) for dy, dx in shifts], 2)
    vm = np.stack([np.roll(np.roll(ok, dy, 0), dx, 1) for dy, dx in shifts], 2)
    w = vm[..., None].astype(np.float64)
    cnt = np.maximum(w.sum(2), 1.0)
    mean = (nb * w).sum(2) / cnt
    cen = (nb - mean[:, :, None, :]) * w
    return np.einsum("hwki,hwkj->hwij", cen, cen) / cnt[..., None]


def estimate_normals_panorama(points, viewpoint=None, width: int = 720, height: int = 240,
                              device=None):
    """Range-image normals (ref calculateNormalsPANORAMA): project the
    local-frame cloud [N,3] (numpy) to an equirectangular range image
    (``ops.panorama``), PCA the 3x3 pixel window of each pixel's point
    and give each point its pixel's normal (occluded points share it).
    The eigenvectors run on ``device`` (None: the first card); the rest
    is host numpy.  Returns [N,3] numpy unit normals facing the
    viewpoint (default the origin)."""
    from .panorama import PanoramaParams, point_pixels

    if device is None:
        from .. import default_device

        device = default_device()
    pts = np.asarray(points, np.float64)
    vp = np.zeros(3) if viewpoint is None else np.asarray(viewpoint)
    params = PanoramaParams(method="equirectangular", width=width, height=height)
    cov = _window_covariances(pts, params)
    cov_t = torch.as_tensor(cov.reshape(-1, 3, 3).astype(np.float32), device=device)
    nrm_img = smallest_eigenvector_sym3(cov_t).cpu().numpy().reshape(height, width, 3)
    ui, vi, _valid = point_pixels(pts, params)
    n = nrm_img[vi, ui].copy()
    flip = (n * (vp[None, :] - pts)).sum(1) < 0
    n[flip] = -n[flip]
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(ln, 1e-30)


def knn_pca_features(points, k: int = 20, viewpoint=None, device=None):
    """(normals [N,3], curvature [N]) as numpy: k-NN normals facing the
    viewpoint (default the origin) and the surface variation
    λ0/(λ0+λ1+λ2) (the scan2features feature set,
    src/slam6d/scan2features.cc).  Runs as :func:`estimate_normals_knn`
    with every point valid."""
    pts, mask, vp = _upload(device, points, None, viewpoint)
    idx, _d2 = knn_ops.knn_brute(pts, mask, pts, mask, k)
    cov = _pca_cov(pts, mask, idx)
    n = _face(smallest_eigenvector_sym3(cov), pts, mask, vp)
    return n.cpu().numpy(), _surface_variation(cov).cpu().numpy()
