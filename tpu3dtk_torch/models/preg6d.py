"""Plane-based post-registration — the port of ``tpu3dtk.models.preg6d``
(the reference's src/preg6d/planereg.cc main program; model/planescan.cc
point-to-plane correspondences; opt/{gaussnewton,adadelta6d}.cc pose
optimizers; match/planematcher.cc local↔global plane matching).

Each point is associated to the plane that minimizes |n·p − d| (within
``eps_hesse``, optionally gated by the angle between the point's normal
and the plane's), then a 6-DoF optimizer minimizes the point-to-plane
energy of one scan against the fixed planes:

- Gauss-Newton: per iteration associate, solve the 6x6 f32 normal
  equations of J = [n, p × n], left-compose a small-angle rotation
  (re-orthonormalized by two Newton steps).  The JAX package's
  ``lax.while_loop`` is a Python loop on the device that reads its
  ``done`` flag once an iteration, so it stops at the same iteration.
- AdaDelta: ``torch.autograd`` of the mean squared hesse energy over the
  scaled Euler pose (the JAX package's ``jax.value_and_grad``), a fixed
  number of iterations with no host read inside the loop.  The argmin
  and the validity weights are constants of the gradient, as under
  ``jax.grad``.

The association is elementwise f32 (``x·nx + y·ny + z·nz − d`` for every
point and plane), not a TF32-prone matmul.  :func:`preg6d` uploads each scan
unpadded: the JAX package pads to a multiple of 512, where the masked
points add nothing.  :func:`match_planes` is host numpy, a copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import math3d
from ..core.scan import Scan
from ..io.frames import AlgoType
from .shapes import HoughParams, Plane, detect_planes

__all__ = [
    "PregParams",
    "associate_points",
    "plane_register",
    "preg6d",
    "match_planes",
]

_BIG = 3.4e38


@dataclasses.dataclass
class PregParams:
    eps_hesse: float = 25.0     # max |n·p − d| for association (cm)
    eps_sim_deg: float = 30.0   # max angle(point normal, plane normal)
    iterations: int = 50        # optimizer iterations
    epsilon: float = 1e-6       # convergence: pose-delta norm
    optimizer: str = "gaussnewton"  # "gaussnewton" | "adadelta"
    use_normals: bool = False   # gate associations by point normals
    adadelta_rho: float = 0.95  # ref adadelta6d.cc decay
    adadelta_eps: float = 1e-6


def _plane_arrays(planes: list[Plane]):
    n = np.stack([p.normal for p in planes]).astype(np.float32)
    d = np.asarray([p.rho for p in planes], np.float32)
    return n, d


def _dots(v, plane_n):
    """[N, P] f32 dot products of the rows of v [N,3] with the plane
    normals [P,3], elementwise."""
    nT = plane_n.T
    return v[:, 0:1] * nT[0] + v[:, 1:2] * nT[1] + v[:, 2:3] * nT[2]


def associate_points(pts_g, mask, plane_n, plane_d, eps_hesse,
                     normals_g=None, cos_sim=None):
    """For each global-frame point, the plane minimizing |n·p − d|.
    Returns (plane_idx [N] int64, signed distance [N], valid [N]); the
    signed distance carries the gradient of ``pts_g``."""
    dist = _dots(pts_g, plane_n) - plane_d
    score = dist.abs()
    if normals_g is not None and cos_sim is not None:
        ndot = _dots(normals_g, plane_n).abs()
        score = torch.where(ndot >= cos_sim, score, _BIG)
    idx = score.detach().argmin(1)
    best = torch.take_along_dim(score, idx[:, None], dim=1)[:, 0]
    signed = torch.take_along_dim(dist, idx[:, None], dim=1)[:, 0]
    valid = mask & (best < eps_hesse)
    return idx, signed, valid


def _small_rotation(dx):
    """[4,4] f32 pose of the update dx = (t, w): I + [w]x with the
    translation, the rotation block re-orthonormalized by two Newton
    steps."""
    one, zero = torch.ones_like(dx[0]), torch.zeros_like(dx[0])
    wx, wy, wz = dx[3], dx[4], dx[5]
    Rr = torch.stack([
        torch.stack([one, -wz, wy]),
        torch.stack([wz, one, -wx]),
        torch.stack([-wy, wx, one]),
    ])
    eye = torch.eye(3, dtype=dx.dtype, device=dx.device)
    for _ in range(2):
        Rr = Rr @ (1.5 * eye - 0.5 * (Rr.T @ Rr))
    top = torch.cat([Rr, dx[:3, None]], dim=1)
    bottom = torch.stack([zero, zero, zero, one])[None]
    return torch.cat([top, bottom], dim=0)


def _gauss_newton(pts_local, mask, plane_n, plane_d, T0, eps_h, eps, normals_local, cs,
                  iterations):
    T = T0
    e = torch.zeros((), dtype=torch.float32, device=T0.device)
    eye6 = torch.eye(6, dtype=torch.float32, device=T0.device)
    it = 0
    while it < iterations:
        pts_g = math3d.transform3(T, pts_local).to(torch.float32)
        nl = None
        if normals_local is not None:
            nl = math3d.transform3normal(T, normals_local).to(torch.float32)
        idx, signed, valid = associate_points(pts_g, mask, plane_n, plane_d, eps_h, nl, cs)
        w = valid.to(torch.float32)
        n_sel = plane_n[idx]
        J = torch.cat([n_sel, torch.linalg.cross(pts_g, n_sel)], dim=1)
        wJ = w[:, None] * J
        A = wJ.T @ J
        b = (wJ * signed[:, None]).sum(0)
        ok = w.sum() > 6
        A = torch.where(ok, A, eye6) + 1e-6 * eye6
        dx = -torch.linalg.solve(A, b)
        dx = torch.where(ok, dx, 0.0)
        T = _small_rotation(dx) @ T
        e = (w * signed * signed).sum()
        it += 1
        if bool(torch.linalg.vector_norm(dx) < eps):
            break
    return T, e, it


def _adadelta(pts_local, mask, plane_n, plane_d, T0, eps_h, normals_local, cs,
              iterations, rho, ae):
    theta0, pos0 = math3d.matrix4_to_euler(T0)
    pose0 = torch.cat([pos0, theta0]).to(torch.float32)
    # rotations act through the scene lever arm: theta is parametrized
    # in rad * scene radius, so all six parameters share the cm scale
    m = mask.to(torch.float32)
    lever = torch.clamp(
        torch.sqrt(((pts_local * m[:, None]) ** 2).sum() / torch.clamp(m.sum(), min=1.0)),
        min=1.0,
    )
    scale = torch.cat([torch.ones(3, device=T0.device), lever.expand(3)])

    def energy(pose6):
        T = math3d.euler_to_matrix4(pose6[:3], pose6[3:])
        pts_g = math3d.transform3(T, pts_local).to(torch.float32)
        nl = None
        if normals_local is not None:
            nl = math3d.transform3normal(T, normals_local).to(torch.float32)
        _idx, signed, valid = associate_points(pts_g, mask, plane_n, plane_d, eps_h, nl, cs)
        w = valid.to(torch.float32)
        return (w * signed * signed).sum() / torch.clamp(w.sum(), min=1.0), valid

    q = (pose0 * scale).detach()
    Eg2 = torch.zeros(6, dtype=torch.float32, device=T0.device)
    Ed2 = torch.zeros_like(Eg2)
    e = torch.zeros((), dtype=torch.float32, device=T0.device)
    for _ in range(iterations):
        qv = q.clone().requires_grad_(True)
        e, _valid = energy(qv / scale)
        (g,) = torch.autograd.grad(e, qv)
        e = e.detach()
        Eg2 = rho * Eg2 + (1 - rho) * g * g
        dx = -torch.sqrt(Ed2 + ae) / torch.sqrt(Eg2 + ae) * g
        Ed2 = rho * Ed2 + (1 - rho) * dx * dx
        q = q + dx
    pose = q / scale
    with torch.no_grad():
        _e, valid = energy(pose)
        T = math3d.euler_to_matrix4(pose[:3], pose[3:])
    return T.to(torch.float32), e, valid


def plane_register(
    pts_local, mask, plane_n, plane_d, T0,
    eps_hesse, epsilon,
    normals_local=None, cos_sim=0.0,
    *,
    iterations: int = 50,
    optimizer: str = "gaussnewton",
    use_normals: bool = False,
    adadelta_rho: float = 0.95,
    adadelta_eps: float = 1e-6,
):
    """Register ONE scan against fixed planes, on the device of its
    tensors (pts_local [N,3], mask [N], plane_n [P,3], plane_d [P], T0
    [4,4]; normals_local [N,3] with ``use_normals``).  Returns (T [4,4]
    f32 tensor, energy, iterations, associated points) with the energy a
    float and the counts ints.

    gaussnewton: the iterations it ran (it stops once |dx| < epsilon);
    the energy Σw·r² of the last iteration's association, before its
    update; the final association is made without normals, as in the
    JAX package.  adadelta: ``iterations`` steps; the mean energy at the
    last step's pose; the final association with normals where
    ``use_normals``."""
    if optimizer not in ("gaussnewton", "adadelta"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    pts_local = pts_local.to(torch.float32)
    T0 = T0.to(torch.float32)
    plane_n = plane_n.to(torch.float32)
    plane_d = plane_d.to(torch.float32)
    dev = pts_local.device
    eps_h = torch.tensor(eps_hesse, dtype=torch.float32, device=dev)
    cs = None
    nl = None
    if use_normals:
        cs = torch.tensor(np.cos(np.deg2rad(cos_sim)), dtype=torch.float32, device=dev)
        nl = normals_local.to(torch.float32)
    if optimizer == "adadelta":
        T, e, valid = _adadelta(
            pts_local, mask, plane_n, plane_d, T0, eps_h, nl, cs, iterations,
            float(np.float32(adadelta_rho)), float(np.float32(adadelta_eps)),
        )
        it = iterations
    else:
        eps = torch.tensor(epsilon, dtype=torch.float32, device=dev)
        T, e, it = _gauss_newton(
            pts_local, mask, plane_n, plane_d, T0, eps_h, eps, nl, cs, iterations,
        )
        pts_g = math3d.transform3(T, pts_local).to(torch.float32)
        _, _, valid = associate_points(pts_g, mask, plane_n, plane_d, eps_h)
    return T, float(e), it, int(valid.sum())


def preg6d(
    scans: list[Scan],
    planes: list[Plane] | None = None,
    params: PregParams | None = None,
    hough: HoughParams | None = None,
    device=None,
) -> list[dict]:
    """Plane-based post-registration of a globally registered sequence
    (planereg.cc's main loop): extract planes from the condensed global
    cloud (SHT) unless given, then refine every scan's pose against the
    fixed plane model.  Mutates the scans' poses (ICP frames).  Runs on
    ``device`` (None: the first card).  Returns info dicts."""
    if device is None:
        from .. import default_device

        device = default_device()
    device = torch.device(device)
    params = params or PregParams()
    if planes is None:
        allpts = np.concatenate(
            [np.asarray(math3d.transform3(s.transMat, s.reduced_local())) for s in scans]
        )
        planes = detect_planes(allpts, hough, device=device)
    if not planes:
        raise ValueError("no planes to register against")
    pn, pd = (torch.as_tensor(a, device=device) for a in _plane_arrays(planes))
    infos = []
    for s in scans:
        pts = torch.as_tensor(np.asarray(s.reduced_local(), np.float32), device=device)
        mask = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
        normals = None
        if params.use_normals:
            normals = torch.as_tensor(
                s.reduced_normals_local().astype(np.float32), device=device
            )
        T, e, it, n_assoc = plane_register(
            pts, mask, pn, pd,
            torch.as_tensor(s.transMat.astype(np.float32), device=device),
            params.eps_hesse, params.epsilon,
            normals_local=normals,
            cos_sim=params.eps_sim_deg,
            iterations=params.iterations,
            optimizer=params.optimizer,
            use_normals=params.use_normals,
            adadelta_rho=params.adadelta_rho,
            adadelta_eps=params.adadelta_eps,
        )
        T = T.cpu().numpy().astype(np.float64)
        u, _, vt = np.linalg.svd(T[:3, :3])
        T[:3, :3] = u @ vt
        s.set_pose(T, AlgoType.ICP)
        infos.append({
            "identifier": s.identifier,
            "energy": e,
            "iterations": it,
            "associated": n_assoc,
        })
    return infos


def match_planes(
    local: list[Plane], global_: list[Plane],
    eps_hesse: float = 50.0, eps_ppd: float = 100.0,
    eps_sim_deg: float = 20.0,
) -> list[tuple[int, int, float]]:
    """Match locally detected planes to the global plane model by the
    reference's three energies (planematcher.cc EnergyPlanePair):
    delta_alpha (normal angle), delta_hesse (|rho| difference),
    delta_ppd (plane-to-plane centroid distance).  Greedy best-first on
    total energy with the same sanity gates.  Returns
    [(local_idx, global_idx, energy)]."""
    if not local or not global_:
        return []
    ln = np.stack([p.normal for p in local])
    gn = np.stack([p.normal for p in global_])
    lr = np.asarray([p.rho for p in local])
    gr = np.asarray([p.rho for p in global_])
    lc = np.stack([p.center for p in local])
    cosang = np.clip(np.abs(ln @ gn.T), -1.0, 1.0)
    d_alpha = np.degrees(np.arccos(cosang))  # [L, G]
    d_hesse = np.abs(lr[:, None] - gr[None, :])
    # point-to-plane distance of the local centroid to the global plane
    d_ppd = np.abs(lc @ gn.T - gr[None, :])
    ok = (
        (d_alpha < eps_sim_deg)
        & (d_hesse < eps_hesse)
        & (d_ppd < eps_ppd)
    )
    energy = d_alpha + d_hesse + d_ppd
    pairs = []
    used_l: set[int] = set()
    used_g: set[int] = set()
    order = np.argsort(energy, axis=None)
    for flat in order:
        li, gi = np.unravel_index(flat, energy.shape)
        if not ok[li, gi] or li in used_l or gi in used_g:
            continue
        pairs.append((int(li), int(gi), float(energy[li, gi])))
        used_l.add(int(li))
        used_g.add(int(gi))
    return pairs
