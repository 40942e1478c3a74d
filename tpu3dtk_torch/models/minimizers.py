"""Closed-form 6-DoF pose minimizers on pair sufficient statistics — the
port of ``tpu3dtk.models.minimizers`` (the reference's ``icp6Dminimizer``
strategies, include/slam6d/icp6Dminimizer.h:31-88, selected by
``slam6D -a``).

Every minimizer consumes the centred sufficient statistics (n,
centroid_m, centroid_d, S) with S = sum_i (d_i - cd)(m_i - cm)^T (rows =
data, cols = model), the reference's parallel-ICP reduction
(icp6D.cc:144-191).  The returned alignment T satisfies m ≈ T·d and is
applied on the left of the current pose (ref Scan::transformMatrix).

Ported: 1 QUAT (Horn unit quaternion, by the same shifted power
iteration as the JAX package, not ``torch.linalg.eigh``) and 2 SVD
(Arun).  The other reference ids (3-10) are ROADMAP item A11.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math3d

__all__ = [
    "PairStats",
    "pair_stats",
    "align_quat",
    "align_svd",
    "MINIMIZERS",
]


class PairStats(NamedTuple):
    """Sufficient statistics of a weighted correspondence set."""

    n: torch.Tensor  # scalar (float) number of pairs
    centroid_m: torch.Tensor  # [3] model centroid
    centroid_d: torch.Tensor  # [3] data centroid
    S: torch.Tensor  # [3,3] centered cross-covariance sum_i (d-cd)(m-cm)^T
    Sdd: torch.Tensor  # [3,3] centered data self-covariance
    Smm: torch.Tensor  # [3,3] centered model self-covariance
    sum_d2: torch.Tensor  # scalar f64 sum |m_i - d_i|^2 (for RMS error)


def pair_stats(m, d, w) -> PairStats:
    """Reduce matched pairs to sufficient statistics.

    m, d: [N,3] model/data points; w: [N] 0/1 (or soft) weights.
    Centred (two-pass) accumulation in f32; ``sum_d2`` in f64, the
    convergence statistic (at 10^5 pairs an f32 sum carries ~1e-6
    relative noise, the size of the two-delta epsilon, and the reference
    sums in f64, icp6D.cc:266-279)."""
    w = w.to(torch.float32)
    m = m.to(torch.float32)
    d = d.to(torch.float32)
    n = w.sum()
    ns = torch.clamp(n, min=1.0)
    cm = (w[:, None] * m).sum(0) / ns
    cd = (w[:, None] * d).sum(0) / ns
    dm = m - cm
    dd = d - cd
    wdd = w[:, None] * dd
    S = wdd.T @ dm
    Sdd = wdd.T @ dd
    Smm = (w[:, None] * dm).T @ dm
    diff = m - d
    sum_d2 = (w * (diff * diff).sum(1)).to(torch.float64).sum()
    return PairStats(
        n=n, centroid_m=cm, centroid_d=cd, S=S, Sdd=Sdd, Smm=Smm, sum_d2=sum_d2
    )


def _finish(R, stats: PairStats):
    """Assemble T = [R | cm - R cd] and the f64 RMS error."""
    t = stats.centroid_m - R @ stats.centroid_d
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    err = torch.sqrt(stats.sum_d2 / torch.clamp(stats.n, min=1.0))
    return T, err


def _max_eigvec4(Q):
    """Dominant eigenvector of a symmetric 4x4 by shifted power iteration
    (the JAX package's algorithm: six renormalised squarings, A^64 v0,
    then one polish step).  The shift 2·||Q||_F makes the target
    eigenvalue the largest in magnitude."""
    eye = torch.eye(4, dtype=Q.dtype, device=Q.device)
    shift = 2.0 * torch.sqrt((Q * Q).sum()) + 1e-12
    A = Q + shift * eye
    A = A / (torch.sqrt((A * A).sum()) + 1e-30)
    for _ in range(6):
        A = A @ A
        A = A / (torch.sqrt((A * A).sum()) + 1e-30)
    v = A @ torch.full((4,), 0.5, dtype=Q.dtype, device=Q.device)
    v = v / (torch.linalg.norm(v) + 1e-30)
    v = (Q + shift * eye) @ v
    return v / (torch.linalg.norm(v) + 1e-30)


def align_quat(stats: PairStats):
    """Horn's unit-quaternion method (ref icp6Dquat.cc:38-145): the
    symmetric 4x4 Q from S/n, its maximum eigenvector by power
    iteration."""
    S = (stats.S / torch.clamp(stats.n, min=1.0)).to(torch.float32)
    trace = torch.trace(S)
    a = torch.stack([S[1, 2] - S[2, 1], S[2, 0] - S[0, 2], S[0, 1] - S[1, 0]])
    Q = torch.empty((4, 4), dtype=S.dtype, device=S.device)
    Q[0, 0] = trace
    Q[0, 1:] = a
    Q[1:, 0] = a
    Q[1:, 1:] = S + S.T - torch.eye(3, dtype=S.dtype, device=S.device) * trace
    q = _max_eigvec4(Q)  # [w, x, y, z] in the reference's convention
    R = math3d.quat_to_matrix3(q).to(S.dtype)
    return _finish(R, stats)


def align_svd(stats: PairStats):
    """Arun's SVD method (ref icp6Dsvd.cc:39-160): H = S (rows = data),
    R = V U^T with the reflection fixed by the sign of det.  As in the
    JAX package, the 3x3 SVD is built from eigh(HᵀH) with U's third
    column completed as u0 × u1."""
    H = stats.S.to(torch.float32)
    _, V = torch.linalg.eigh(H.T @ H)  # ascending eigenvalues
    V = V.flip(1)
    u0 = H @ V[:, 0]
    u0 = u0 / torch.clamp(torch.linalg.norm(u0), min=1e-12)
    u1 = H @ V[:, 1]
    u1 = u1 - u0 * torch.dot(u0, u1)
    u1 = u1 / torch.clamp(torch.linalg.norm(u1), min=1e-12)
    u2 = torch.linalg.cross(u0, u1)
    U = torch.stack([u0, u1, u2], dim=1)
    D = torch.eye(3, dtype=H.dtype, device=H.device)
    D[2, 2] = torch.sign(torch.linalg.det(V @ U.T))
    R = V @ D @ U.T
    return _finish(R, stats)


MINIMIZERS = {
    "quat": align_quat,  # -a 1  (icp6Dquat.cc)
    "svd": align_svd,  # -a 2  (icp6Dsvd.cc)
}


def get_minimizer(name: str):
    """The minimizer called ``name``; the unported ones raise."""
    try:
        return MINIMIZERS[name]
    except KeyError:
        raise NotImplementedError(
            f"minimizer {name!r} is not ported yet (ROADMAP A11: "
            "minimizers -a 3..10); ported: " + ", ".join(MINIMIZERS)
        ) from None
