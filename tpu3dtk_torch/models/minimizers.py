"""Closed-form 6-DoF pose minimizers on pair sufficient statistics — the
port of ``tpu3dtk.models.minimizers`` (the reference's ``icp6Dminimizer``
strategies, include/slam6d/icp6Dminimizer.h:31-88, selected by
``slam6D -a``).

Every minimizer consumes the centred sufficient statistics (n,
centroid_m, centroid_d, S) with S = sum_i (d_i - cd)(m_i - cm)^T (rows =
data, cols = model), the reference's parallel-ICP reduction
(icp6D.cc:144-191).  The returned alignment T satisfies m ≈ T·d and is
applied on the left of the current pose (ref Scan::transformMatrix).

All ten reference ids (``MINIMIZERS``, keyed by the names of
``cli/slam6d.py::ALGO_NAMES``), with the JAX package's math:
  1 QUAT   Horn unit quaternion, by the JAX package's shifted power
           iteration, not ``torch.linalg.eigh`` (icp6Dquat.cc:38-145)
  2 SVD    Arun SVD of the cross-covariance (icp6Dsvd.cc:39-160)
  3 ORTHO  Horn orthonormal matrices, polar factor via eigh(HᵀH)
           (icp6Dortho.cc:85-135)
  4 DUAL   Walker dual quaternions (icp6Ddual.cc:41-152)
  5 HELIX  Hofer/Pottmann helical motion (icp6Dhelix.cc:48-204)
  6 APX    small-angle linearization (icp6Dapx.cc)
  7 LUMEULER / 8 LUMQUAT  Lu/Milios single-pair linearizations in Euler /
           quaternion form, given the current pose (icp6Dlumeuler.cc,
           icp6Dlumquat.cc:40-230)
  9 QUATSCALE  Horn quaternion + scale (icp6Dquatscale.cc)
 10 NAPX   point-to-plane small-angle normal equations on
           :class:`NapxStats` (icp6Dnapx.cc:36-150)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math3d
from ..parallel.mesh import allsum

__all__ = [
    "MINIMIZERS",
    "NapxStats",
    "PairStats",
    "align_apx",
    "align_dual",
    "align_helix",
    "align_lumeuler",
    "align_lumquat",
    "align_napx",
    "align_ortho",
    "align_quat",
    "align_quat_scale",
    "align_svd",
    "get_minimizer",
    "napx_stats",
    "pair_stats",
]

# the minimizers that take the current pose as a second argument (ref
# icp6D.cc:242-245: algo 7/8 receive it)
POSE_MINIMIZERS = ("lumeuler", "lumquat")


class PairStats(NamedTuple):
    """Sufficient statistics of a weighted correspondence set."""

    n: torch.Tensor  # scalar (float) number of pairs
    centroid_m: torch.Tensor  # [3] model centroid
    centroid_d: torch.Tensor  # [3] data centroid
    S: torch.Tensor  # [3,3] centered cross-covariance sum_i (d-cd)(m-cm)^T
    Sdd: torch.Tensor  # [3,3] centered data self-covariance
    Smm: torch.Tensor  # [3,3] centered model self-covariance
    sum_d2: torch.Tensor  # scalar f64 sum |m_i - d_i|^2 (for RMS error)

    # uncentred raw sums, derived (the dual, helix and lum forms use them)
    @property
    def sum_m(self):
        return self.n * self.centroid_m

    @property
    def sum_d(self):
        return self.n * self.centroid_d

    @property
    def Dm(self):
        """sum d m^T (uncentred)."""
        return self.S + self.n * torch.outer(self.centroid_d, self.centroid_m)

    @property
    def Dd(self):
        """sum d d^T (uncentred)."""
        return self.Sdd + self.n * torch.outer(self.centroid_d, self.centroid_d)

    @property
    def Mm(self):
        """sum m m^T (uncentred)."""
        return self.Smm + self.n * torch.outer(self.centroid_m, self.centroid_m)


def pair_stats(m, d, w, group=None) -> PairStats:
    """Reduce matched pairs to sufficient statistics.

    m, d: [N,3] model/data points; w: [N] 0/1 (or soft) weights.
    Centred (two-pass) accumulation in f32; ``sum_d2`` in f64, the
    convergence statistic (at 10^5 pairs an f32 sum carries ~1e-6
    relative noise, the size of the two-delta epsilon, and the reference
    sums in f64, icp6D.cc:266-279).

    ``group``: a ``torch.distributed`` process group over which the pairs
    are split (the JAX package's ``axis_name``): the first moments are
    summed over its ranks before centring, the second moments after, the
    Langis partial-sum merge (icp6D.cc:144-191, icp6Dminimizer.h:61-82);
    f32 sums in f32, ``sum_d2`` in f64."""
    w = w.to(torch.float32)
    m = m.to(torch.float32)
    d = d.to(torch.float32)
    n, sm, sd = allsum(group, w.sum()[None], (w[:, None] * m).sum(0), (w[:, None] * d).sum(0))
    n = n[0]
    ns = torch.clamp(n, min=1.0)
    cm = sm / ns
    cd = sd / ns
    dm = m - cm
    dd = d - cd
    wdd = w[:, None] * dd
    S, Sdd, Smm = allsum(group, wdd.T @ dm, wdd.T @ dd, (w[:, None] * dm).T @ dm)
    diff = m - d
    (sum_d2,) = allsum(group, (w * (diff * diff).sum(1)).to(torch.float64).sum())
    return PairStats(
        n=n, centroid_m=cm, centroid_d=cd, S=S, Sdd=Sdd, Smm=Smm, sum_d2=sum_d2
    )


def _finish(R, stats: PairStats):
    """Assemble T = [R | cm - R cd] and the f64 RMS error."""
    t = stats.centroid_m - R @ stats.centroid_d
    # built out of place, so that torch.func.vmap can batch it, and by a
    # fill on the device (no host copy), so that a CUDA graph can hold it
    last = _eye(4, R)[3:]
    T = torch.cat([torch.cat([R, t[:, None].to(R.dtype)], 1), last], 0)
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
    Q = torch.cat([
        torch.cat([trace[None], a])[None],
        torch.cat([a[:, None], S + S.T - torch.eye(3, dtype=S.dtype, device=S.device) * trace], 1),
    ])
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


def _rms(stats):
    return torch.sqrt(stats.sum_d2 / torch.clamp(stats.n, min=1.0))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _embed(R, t):
    T = _eye(4, R)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _axial(P):
    """[P12-P21, P20-P02, P01-P10] over the last two axes: the axial
    vector of sum a x b for P = sum a b^T."""
    return torch.stack([
        P[..., 1, 2] - P[..., 2, 1], P[..., 2, 0] - P[..., 0, 2], P[..., 0, 1] - P[..., 1, 0],
    ], dim=-1)


def _skew(v):
    """[..., 3] -> [..., 3, 3] cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        torch.stack([z, -w, y], -1), torch.stack([w, z, -x], -1), torch.stack([-y, x, z], -1),
    ], dim=-2)


def _rodrigues(a):
    """exp([a]x) of a rotation vector (the JAX package adds 1e-30 to the
    angle rather than branching at zero)."""
    th = torch.linalg.norm(a) + 1e-30
    K = _skew(a / th)
    return _eye(3, a) + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)


def align_ortho(stats: PairStats):
    """Horn's orthonormal-matrix method (ref icp6Dortho.cc:85-135): with
    H = Σ m̃ d̃ᵀ the rotation is the polar factor R = H (HᵀH)^(-1/2),
    through the eigendecomposition of HᵀH; degenerate eigenvalues are
    clamped so the inverse square root stays finite."""
    H = stats.S.T.to(torch.float32)  # S = Σ d̃ m̃ᵀ  ⇒  H = Σ m̃ d̃ᵀ
    lam, E = torch.linalg.eigh(H.T @ H)
    inv_sqrt = torch.rsqrt(torch.clamp(lam, min=1e-12))
    return _finish(H @ (E * inv_sqrt[None, :]) @ E.T, stats)


def align_apx(stats: PairStats):
    """Small-angle linearization (ref icp6Dapx.cc): the normal equations
    (tr(Sdd) I - Sdd) a = axial(S) for the rotation vector a, returned
    through the exact exponential map, as the JAX package does."""
    n = torch.clamp(stats.n, min=1.0)
    S = (stats.S / n).to(torch.float32)
    Sdd = (stats.Sdd / n).to(torch.float32)
    A = torch.trace(Sdd) * _eye(3, S) - Sdd
    a = torch.linalg.solve(A, _axial(S))
    return _finish(_rodrigues(a), stats)


def align_dual(stats: PairStats):
    """Walker/Shao/Volz dual-quaternion method (ref icp6Ddual.cc:41-152)
    from raw sums: with P = sum m d^T,
      C1 = -2 [ tr(P), -axial(P)^T ; -axial(P), P + P^T - tr(P) I ]
      C2 =  2 [ 0, (sm-sd)^T ; sd-sm, -skew(sm+sd) ]
    and the rotation quaternion the dominant eigenvector of
    A = (C2^T C2/(2n) - C1 - C1^T)/2."""
    f32 = torch.float32
    P = stats.Dm.T.to(f32)
    sm, sd = stats.sum_m.to(f32), stats.sum_d.to(f32)
    n = torch.clamp(stats.n, min=1.0).to(f32)
    ax, tr = _axial(P), torch.trace(P)
    C1 = torch.zeros((4, 4), dtype=f32, device=P.device)
    C1[0, 0] = tr
    C1[0, 1:] = -ax
    C1[1:, 0] = -ax
    C1[1:, 1:] = P + P.T - tr * _eye(3, P)
    C1 = -2.0 * C1
    C2 = torch.zeros_like(C1)
    C2[0, 1:] = sm - sd
    C2[1:, 0] = sd - sm
    C2[1:, 1:] = -_skew(sm + sd)
    C2 = 2.0 * C2
    qdot = _max_eigvec4(0.5 * (C2.T @ C2 / (2.0 * n) - C1 - C1.T))
    qvec = qdot[1:]
    s = -(C2 @ qdot) / (2.0 * n)
    Q = torch.zeros_like(C1)
    Q[0, 0] = qdot[0]
    Q[0, 1:] = qvec
    Q[1:, 0] = -qvec
    Q[1:, 1:] = qdot[0] * _eye(3, P) + _skew(qvec)
    t = (Q @ s)[1:]
    R = (
        (qdot[0] * qdot[0] - (qvec * qvec).sum()) * _eye(3, P)
        + 2.0 * torch.outer(qvec, qvec)
        + 2.0 * qdot[0] * _skew(qvec)
    )
    return _embed(R, t), _rms(stats)


def _helix_rt(ccs):
    """icp6D_HELIX::computeRt (icp6Dhelix.cc:144-204): helix parameters
    (c; c̄) [6] -> (R, t), in ``ccs``' dtype.

    Where |c| < 1e-12 (exactly aligned pairs: c = 0, and c·c̄ / |c|²
    would be 0/0) this takes the zero-rotation limit R = I, t = c̄, as
    ``graphslam_variants._helix_computeRt`` does; the JAX package's ICP
    ``align_helix`` returns a NaN translation there."""
    c, cs = -ccs[:3], -ccs[3:]
    norm = torch.sqrt((c * c).sum())
    still = norm < 1e-12
    clen = torch.where(still, torch.ones_like(norm), norm)
    angle = torch.arctan(clen)
    g = c / clen
    half = -angle / 2.0
    q = torch.cat([torch.cos(half)[None], g * torch.sin(half)])
    # computeRt writes the transposed quaternion-matrix convention
    # (icp6Dhelix.cc:169-178)
    R = math3d.quat_to_matrix3(q / torch.linalg.norm(q)).to(ccs.dtype).T
    skew_val = (c * cs).sum() / (clen * clen)
    gs = (cs - c * skew_val) / clen
    ptemp = torch.linalg.cross(g, gs)
    t = R @ (-ptemp) + g * (skew_val * angle) + ptemp
    return torch.where(still, _eye(3, R), R), torch.where(still, cs, t)


def align_helix(stats: PairStats):
    """Hofer/Pottmann helical-motion approximation (ref
    icp6Dhelix.cc:48-204): the 6x6 system B (c; c̄) = bd from data-point
    raw sums (B = [tr(Dd) I - Dd, skew(sd); skew(sd)^T, n I], bd =
    (-axial(Dm); sd - sm)), then the helix exponential."""
    f32 = torch.float32
    Dd, Dm = stats.Dd.to(f32), stats.Dm.to(f32)
    sd, sm = stats.sum_d.to(f32), stats.sum_m.to(f32)
    n = torch.clamp(stats.n, min=1.0).to(f32)
    B = torch.zeros((6, 6), dtype=f32, device=Dd.device)
    B[:3, :3] = torch.trace(Dd) * _eye(3, Dd) - Dd
    Sk = _skew(sd)
    B[:3, 3:] = Sk
    B[3:, :3] = Sk.T
    B[3:, 3:] = n * _eye(3, Dd)
    ccs = torch.linalg.solve(B, torch.cat([-_axial(Dm), sd - sm]))
    return _embed(*_helix_rt(ccs)), _rms(stats)


def align_quat_scale(stats: PairStats):
    """Horn unit quaternion + symmetric scale (ref icp6Dquatscale.cc):
    the rotation of :func:`align_quat`, s = sqrt(Σ|m̃|² / Σ|d̃|²),
    translation cm - s R cd."""
    T, err = align_quat(stats)
    R = T[:3, :3]
    s = torch.sqrt(
        torch.clamp(torch.trace(stats.Smm), min=1e-30)
        / torch.clamp(torch.trace(stats.Sdd), min=1e-30)
    ).to(R.dtype)
    t = stats.centroid_m.to(R.dtype) - s * (R @ stats.centroid_d.to(R.dtype))
    return _embed(s * R, t), err


def _mid_moments(stats: PairStats):
    """n, Σu, Σuuᵀ, Σδ of the Lu/Milios linearization over midpoints
    u = (m+d)/2 and deltas δ = m - d, from the raw moments (f32)."""
    f32 = torch.float32
    n = torch.clamp(stats.n, min=1.0).to(f32)
    sm, sd = stats.sum_m.to(f32), stats.sum_d.to(f32)
    Mm, Dd, Dm = stats.Mm.to(f32), stats.Dd.to(f32), stats.Dm.to(f32)
    return n, 0.5 * (sm + sd), 0.25 * (Mm + Dd + Dm + Dm.T), sm - sd, Mm, Dd, Dm


def _mid_delta_system(stats: PairStats):
    """MZ (6,) and MM (6,6) of the Lu/Milios linearization — the sums of
    covarianceEuler (lum6Deuler.cc:141-195) from raw moments.  The
    reference's component order (lum6Deuler.cc:170-175): MZ4 = (u×δ)_x,
    MZ5 = (u×δ)_z, MZ6 = (u×δ)_y, and Σ u×δ = axial(Dm)."""
    n, su, Uu, sdelta, _Mm, _Dd, Dm = _mid_moments(stats)
    uxd = _axial(Dm)
    MZ = torch.cat([sdelta, torch.stack([uxd[0], uxd[2], uxd[1]])])
    sx, sy, sz = su
    x2, y2, z2 = Uu[0, 0], Uu[1, 1], Uu[2, 2]
    xy, xz, yz = Uu[0, 1], Uu[0, 2], Uu[1, 2]
    o = torch.zeros_like(n)

    def row(*v):
        return torch.stack(v)

    MM = torch.stack([
        row(n, o, o, o, -sy, sz),
        row(o, n, o, -sz, sx, o),
        row(o, o, n, sy, o, -sx),
        row(o, -sz, sy, y2 + z2, -xz, -xy),
        row(-sy, sx, o, -xz, x2 + y2, -yz),
        row(sz, o, -sx, -xy, -yz, x2 + z2),
    ])
    return MZ, MM


def _current_pose(T_cur, like):
    if T_cur is None:
        return _eye(4, like)
    return torch.as_tensor(T_cur, device=like.device).to(like.dtype)


def align_lumeuler(stats: PairStats, T_cur=None):
    """Lu/Milios single-pair Euler minimizer (ref icp6Dlumeuler.cc): the
    pose-difference estimate Ehat = MM⁻¹ MZ in the global frame, mapped
    through the pose Jacobian H at the current pose ``T_cur``; the
    applied alignment is T1 T2⁻¹."""
    MZ, MM = _mid_delta_system(stats)
    Ehat = torch.linalg.solve(MM, MZ)
    T_cur = _current_pose(T_cur, MZ)
    theta, pos = math3d.matrix4_to_euler(T_cur)
    tx, ty, tz = pos
    cx, sx = torch.cos(theta[0]), torch.sin(theta[0])
    cy, sy = torch.cos(theta[1]), torch.sin(theta[1])
    H = _eye(6, MZ)
    H[0, 4] = -tz * cx + ty * sx
    H[0, 5] = ty * cx * cy + tz * cy * sx
    H[1, 3] = tz
    H[1, 4] = -tx * sx
    H[1, 5] = -tx * cx * cy + tz * sy
    H[2, 3] = -ty
    H[2, 4] = tx * cx
    H[2, 5] = -tx * cy * sx - ty * sy
    H[3, 5] = sy
    H[4, 4] = sx
    H[4, 5] = cx * cy
    H[5, 4] = cx
    H[5, 5] = -cy * sx
    X = torch.cat([pos, theta]) - torch.linalg.solve(H, Ehat)
    T1 = math3d.euler_to_matrix4(pos, theta).to(MZ.dtype)
    T2 = math3d.euler_to_matrix4(X[:3], X[3:]).to(MZ.dtype)
    return T1 @ math3d.m4inv(T2).to(MZ.dtype), _rms(stats)


def align_lumquat(stats: PairStats, T_cur=None):
    """Lu/Milios single-pair quaternion minimizer (ref
    icp6Dlumquat.cc:40-230): the 7-dof linearization

        MZ = [Σδ ; Σu·δ ; -Σ u×δ],  MM = the 7x7 Gram matrix,

    Ehat = MM⁻¹MZ mapped through the pose Jacobian H (identity / -2T / 2U
    blocks of the current quaternion and translation,
    icp6Dlumquat.cc:146-160), returned as T1·T2⁻¹ with T2 built from the
    raw (unnormalised) quaternion and inverted as a general matrix, as
    the reference does.  The midpoint is the true one (the reference's
    x-component typo (p1.x+p1.x)/2 is not copied, as in the JAX
    package)."""
    n, su, Uu, sdelta, Mm, Dd, Dm = _mid_moments(stats)
    u_dot_delta = 0.5 * (torch.trace(Mm) - torch.trace(Dd))
    MZ = torch.cat([sdelta, u_dot_delta[None], -_axial(Dm)])
    sx, sy, sz = su
    x2, y2, z2 = Uu[0, 0], Uu[1, 1], Uu[2, 2]
    xy, xz, yz = Uu[0, 1], Uu[0, 2], Uu[1, 2]
    o = torch.zeros_like(n)

    def row(*v):
        return torch.stack(v)

    MM = torch.stack([
        row(n, o, o, sx, o, -sz, sy),
        row(o, n, o, sy, sz, o, -sx),
        row(o, o, n, sz, -sy, sx, o),
        row(sx, sy, sz, x2 + y2 + z2, o, o, o),
        row(o, sz, -sy, o, y2 + z2, -xy, -xz),
        row(-sz, o, sx, o, -xy, x2 + z2, -yz),
        row(sy, -sx, o, o, -xz, -yz, x2 + y2),
    ])
    Ehat = torch.linalg.solve(MM, MZ)
    T_cur = _current_pose(T_cur, MZ)
    quat = math3d.matrix4_to_quat(T_cur).to(MZ.dtype)
    p, q, r, s = quat
    x, y, zc = T_cur[0, 3], T_cur[1, 3], T_cur[2, 3]
    U = torch.stack([
        row(p, q, r, s),
        row(q, -p, s, -r),
        row(r, -s, -p, q),
        row(s, r, -q, -p),
    ])
    Tm = torch.stack([
        row(p * x + s * y - r * zc, q * x + r * y + s * zc,
            r * x - q * y + p * zc, s * x - p * y - q * zc),
        row(-s * x + p * y + q * zc, -r * x + q * y - p * zc,
            q * x + r * y + s * zc, p * x + s * y - r * zc),
        row(r * x - q * y + p * zc, -s * x + p * y + q * zc,
            -p * x - s * y + r * zc, q * x + r * y - s * zc),
    ])
    H = torch.zeros((7, 7), dtype=MZ.dtype, device=MZ.device)
    H[:3, :3] = _eye(3, MZ)
    H[:3, 3:] = -2.0 * Tm
    H[3:, 3:] = 2.0 * U
    txyz = torch.stack([x, y, zc])
    X = torch.cat([txyz, quat]) - torch.linalg.solve(H, Ehat)
    T1 = math3d.quat_to_matrix4(quat, txyz).to(MZ.dtype)
    T2 = math3d.quat_to_matrix4(X[3:], X[:3]).to(MZ.dtype)
    return T1 @ torch.linalg.inv(T2), _rms(stats)


class NapxStats(NamedTuple):
    """Sufficient statistics of the point-to-plane linearization
    (icp6Dnapx.cc): per pair, residual d = (m−t)·n̂, lever c = (t−cd)×n̂;
    A = Σ [c;n][c;n]ᵀ (6x6), b = Σ d·[c;n] (6,)."""

    n: torch.Tensor
    A: torch.Tensor  # [6,6]
    b: torch.Tensor  # [6]
    centroid_d: torch.Tensor  # [3]
    sum_d2: torch.Tensor  # Σ d² (point-to-plane RMS)


def napx_stats(m, t, normals, w, group=None) -> NapxStats:
    """Matched model points m [N,3], target points t [N,3], unit normals
    at the targets [N,3] and weights w [N] -> NapxStats (f32).
    ``group``: the pairs split over a process group, the sums merged as
    in :func:`pair_stats`."""
    w = w.to(torch.float32)
    m, t, nrm = m.to(torch.float32), t.to(torch.float32), normals.to(torch.float32)
    n, st = allsum(group, w.sum()[None], (w[:, None] * t).sum(0))
    n = n[0]
    cd = st / torch.clamp(n, min=1.0)
    d = ((m - t) * nrm).sum(1)
    J = torch.cat([torch.linalg.cross(t - cd, nrm), nrm], dim=1)  # [N,6]
    wJ = w[:, None] * J
    A, b, sum_d2 = allsum(group, wJ.T @ J, (wJ * d[:, None]).sum(0), (w * d * d).sum())
    return NapxStats(n=n, A=A, b=b, centroid_d=cd, sum_d2=sum_d2)


def align_napx(stats: NapxStats):
    """Point-to-plane small-angle minimizer (ref icp6Dnapx.cc:36-150):
    A x = b for x = (sin-angles; translation), R rebuilt in the
    reference's EulerToMatrix4 layout from the arcsines, translation
    recentred about the data centroid, t = x[3:] + cd − R·cd.  As in the
    JAX package, b = Σ d·[c;n] (the reference omits the residual factor
    d, an evident bug in its normal equations)."""
    f32 = torch.float32
    A = stats.A.to(f32) + 1e-9 * _eye(6, stats.A.to(f32))
    x = torch.linalg.solve(A, stats.b.to(f32))
    R = math3d.euler_to_matrix3(torch.arcsin(torch.clamp(x[:3], -1.0, 1.0))).to(f32)
    cd = stats.centroid_d.to(f32)
    return _embed(R, x[3:] + cd - R @ cd), _rms(stats)


MINIMIZERS = {
    "quat": align_quat,  # -a 1  (icp6Dquat.cc)
    "svd": align_svd,  # -a 2  (icp6Dsvd.cc)
    "ortho": align_ortho,  # -a 3  (icp6Dortho.cc)
    "dual": align_dual,  # -a 4  (icp6Ddual.cc)
    "helix": align_helix,  # -a 5  (icp6Dhelix.cc)
    "apx": align_apx,  # -a 6  (icp6Dapx.cc)
    "lumeuler": align_lumeuler,  # -a 7 (icp6Dlumeuler.cc; takes the pose)
    "lumquat": align_lumquat,  # -a 8 (icp6Dlumquat.cc; takes the pose)
    "quatscale": align_quat_scale,  # -a 9 (icp6Dquatscale.cc)
    "napx": align_napx,  # -a 10 (icp6Dnapx.cc; NapxStats, needs normals)
}


def get_minimizer(name: str):
    """The minimizer called ``name``; an unknown name raises."""
    try:
        return MINIMIZERS[name]
    except KeyError:
        raise ValueError(
            f"unknown minimizer {name!r}; known: " + ", ".join(MINIMIZERS)
        ) from None
