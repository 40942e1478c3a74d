"""Normal estimation — the port of ``tpu3dtk.ops.normals``'
``estimate_normals_knn`` (the reference's ``calculateNormalsKNN``,
src/slam6d/normals.cc:220-440).

Per point: PCA over its k nearest neighbours (``ops.knn.knn_brute``);
the normal is the eigenvector of the smallest eigenvalue of the
neighbourhood covariance, flipped to face the viewpoint (the scanner
position), the reference's orientation rule.  The symmetric 3x3
eigenproblem is solved in closed form (trigonometric Cardano, then the
largest cross product of the rows of A − λI), batched, as in the JAX
package.  Plain torch on the tensors' device: the JAX package has no
Pallas kernel here.  The adaptive, approximate and panorama estimators
are not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import knn as knn_ops

__all__ = ["estimate_normals_knn", "smallest_eigenvector_sym3", "sym3_eigenvalues"]


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


def estimate_normals_knn(points, mask, viewpoint, k: int = 20, device=None):
    """Normals of a padded cloud from k-NN PCA.

    points [N,3], mask [N], viewpoint [3] (the scanner position in the
    points' frame): torch tensors (the work runs on their device) or
    numpy arrays (uploaded to ``device``; None: the package default,
    the first CUDA card).  Returns unit normals [N,3] f32 on that
    device, oriented toward the viewpoint, zero where masked out."""
    if not isinstance(points, torch.Tensor):
        from .. import default_device

        dev = default_device() if device is None else torch.device(device)
        points = torch.as_tensor(np.asarray(points, np.float32), device=dev)
        mask = torch.as_tensor(np.asarray(mask, bool), device=dev)
        viewpoint = torch.as_tensor(np.asarray(viewpoint, np.float32), device=dev)
    points = points.to(torch.float32)
    idx, _d2 = knn_ops.knn_brute(points, mask, points, mask, k)
    nbrs = points[idx]  # [N, k, 3]
    w = mask[idx].to(torch.float32)[..., None]  # fewer than k valid points
    cnt = torch.clamp(w.sum(1), min=1.0)
    mean = (nbrs * w).sum(1) / cnt
    cen = (nbrs - mean[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", cen, cen) / cnt[..., None]
    n = smallest_eigenvector_sym3(cov)
    flip = (n * (viewpoint.to(torch.float32)[None, :] - points)).sum(-1) < 0.0
    n = torch.where(flip[:, None], -n, n)
    return torch.where(mask[:, None], n, 0.0)
