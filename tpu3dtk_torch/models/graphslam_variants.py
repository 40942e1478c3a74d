"""Alternative GraphSLAM relaxations — the port of
``tpu3dtk/models/graphslam_variants.py``: quaternion LUM (``lum6DQuat``,
ref src/slam6d/lum6Dquat.cc:84-477), global helix (``ghelix6DQ2``, ref
src/slam6d/ghelix6DQ2.cc:89-457) and global small angle (``gapx6D``, ref
src/slam6d/gapx6D.cc:76-545), the reference's ``-G 2/3/4`` beside the
Euler LUM of ``models.graphslam`` (``-G 1``).

All three are linear(ized) least squares over the same point pairs, so
every per-link quantity any of them needs derives from six raw sums per
link (a = the NN point in scan i, b = the point of scan j, both in the
global frame):

    m = pair count,  sa = Σa,  sb = Σb,  Paa = Σaaᵀ,  Pbb = Σbbᵀ,  Pab = Σabᵀ

:func:`link_raw_sums` computes them for all links: one brute NN call per
link (kernel K1 on the card, on a model prepared for the link; the JAX
package runs its plain XLA NN here), the sums of ``LINK_CHUNK`` links
reduced together in f64 from one flat gather.  Each variant then builds
its per-link blocks in f64, scatters them into the dense system with
``index_put_`` on the device, solves it in f64 there and reads back the
solution once an iteration.  The systems are dense at every size (as in
the JAX package; no block-CG takes over, unlike ``-G 1``): a quaternion
system of n scans holds (7n)² f64 entries a copy.  The pose updates (a
7x7 Jacobian per scan for the quaternion LUM, a helix or rotation-vector
exponential for the others) run on the host in f64 numpy.  The math is the JAX package's,
including its stated departures from the reference (gapx's exact
Gauss–Newton normal equations instead of the reference's copy-paste
slips).  The correspondence cache is not used: as in the JAX package,
the variants recompute every link's pairing every iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math3d
from ..core.scan import Scan
from ..io.frames import AlgoType
from ..ops import nn as nn_ops
from ..utils.metrics import metrics
from . import graphslam as gs
from .graphslam import LumParams
from .minimizers import _axial, _eye, _skew

__all__ = [
    "GRAPHSLAM_VARIANTS",
    "do_graph_slam_apx",
    "do_graph_slam_helix",
    "do_graph_slam_quat",
    "link_raw_sums",
]

# metrics counter: NN calls of the raw sums (one brute NN call, kernel K1
# on the card, per link and call)
RAW_LINK_CALLS = "raw_sum_link_calls"
RAW_KEYS = ("m", "sa", "sb", "Paa", "Pbb", "Pab")


def link_raw_sums(points_g, masks, links, max_dist2):
    """The six raw sums of every link: f64 tensors m [L], sa, sb [L,3],
    Paa, Pbb, Pab [L,3,3] on the device of ``points_g``.

    points_g [S,N,3] f32 global-frame points, masks [S,N], links [L,2]
    host array.  Pairs of link (i, j) are the NN of scan j's points
    among scan i's (the Scan::getPtPairs convention of every FillGB-style
    loop); matches at or beyond ``max_dist2`` are rejected."""
    md2 = float(np.float32(max_dist2))
    links = np.asarray(links, np.int64).reshape(-1, 2)
    N = points_g.shape[1]
    dev = points_g.device
    outs = []
    for c0 in range(0, len(links), gs.LINK_CHUNK):
        chunk = links[c0 : c0 + gs.LINK_CHUNK]
        idx = torch.empty((len(chunk), N), dtype=torch.int64, device=dev)
        found = torch.empty((len(chunk), N), dtype=torch.bool, device=dev)
        for k, (i, j) in enumerate(chunk.tolist()):
            idx[k], _d2, found[k] = nn_ops.nn_brute_auto(
                points_g[j], masks[j], points_g[i], masks[i], md2
            )
        metrics.count(RAW_LINK_CALLS, len(chunk))
        a, b = gs.gather_pairs(points_g, torch.as_tensor(chunk, device=dev), idx)
        w = found.to(torch.float64)[..., None]
        a, b = a.double(), b.double()
        aw, bw = a * w, b * w
        outs.append((
            w[..., 0].sum(-1), aw.sum(-2), bw.sum(-2),
            aw.transpose(-1, -2) @ a, bw.transpose(-1, -2) @ b,
            aw.transpose(-1, -2) @ b,
        ))
    if not outs:
        z = torch.zeros((0, 3, 3), dtype=torch.float64, device=dev)
        outs = [(z[:, 0, 0], z[:, 0], z[:, 0], z, z, z)]
    return {k: torch.cat([o[n] for o in outs]) for n, k in enumerate(RAW_KEYS)}


def _collect_raw(scans: list[Scan], links, params: LumParams):
    """Raw sums of ``links`` at the scans' current poses.  With
    ``params.device_points`` (GraphPipeline's resident [S, cap] upload)
    only the [S,4,4] pose stack goes up, padded with identity beyond the
    given scans; otherwise the reduced points are padded and uploaded."""
    if params.device_points is not None:
        locals_t, masks_t = params.device_points
        S = int(locals_t.shape[0])
        mats = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
        for si, s in enumerate(scans):
            mats[si] = s.transMat
    else:
        dev = gs._resolve_device(params.device)
        cap = gs._round_up(max(len(s.reduced_local()) for s in scans), gs._PAD)
        locals_pad, masks = gs._pad_scan_points(scans, cap)
        locals_t = torch.as_tensor(locals_pad, device=dev)
        masks_t = torch.as_tensor(masks, device=dev)
        mats = np.stack([s.transMat for s in scans]).astype(np.float32)
    points_g = gs.global_points(locals_t, torch.as_tensor(mats, device=locals_t.device))
    return link_raw_sums(points_g, masks_t, links, params.max_dist_match2)


def _trace(P):
    return torch.diagonal(P, dim1=-2, dim2=-1).sum(-1)


def _quat_link_CCD(raw):
    """C [L,7,7], CD [L,7] of every link (covarianceQuat,
    lum6Dquat.cc:84-233) from the raw sums, batched: mid/delta moments
    Σmid = (sa+sb)/2, Σ mid midᵀ = (Paa+Pab+Pabᵀ+Pbb)/4,
    Σ mid dᵀ = (Paa−Pab+Pabᵀ−Pbb)/2, Σ d dᵀ = Paa−Pab−Pabᵀ+Pbb, and the
    residual variance ss = (tr Σddᵀ − Dᵀ MZ) / (2m−3).  Links with m <= 2,
    a singular MM or ss < 1e-13 get zero blocks, as in the JAX package."""
    m, sa, sb = raw["m"], raw["sa"], raw["sb"]
    Paa, Pbb, Pab = raw["Paa"], raw["Pbb"], raw["Pab"]
    PabT = Pab.transpose(-1, -2)
    smid = 0.5 * (sa + sb)
    Pmm = 0.25 * (Paa + Pab + PabT + Pbb)
    Pmd = 0.5 * (Paa - Pab + PabT - Pbb)
    Pdd = Paa - Pab - PabT + Pbb
    MZ = torch.cat([sa - sb, _trace(Pmd)[:, None], -_axial(Pmd)], dim=-1)
    sx, sy, sz = smid[:, 0], smid[:, 1], smid[:, 2]
    xx, yy, zz = Pmm[:, 0, 0], Pmm[:, 1, 1], Pmm[:, 2, 2]
    xy, xz, yz = Pmm[:, 0, 1], Pmm[:, 0, 2], Pmm[:, 1, 2]
    o = torch.zeros_like(m)

    def row(*v):
        return torch.stack(v, dim=-1)

    MM = torch.stack([
        row(m, o, o, sx, o, -sz, sy),
        row(o, m, o, sy, sz, o, -sx),
        row(o, o, m, sz, -sy, sx, o),
        row(sx, sy, sz, xx + yy + zz, o, o, o),
        row(o, sz, -sy, o, yy + zz, -xy, -xz),
        row(-sz, o, sx, o, -xy, xx + zz, -yz),
        row(sy, -sx, o, o, -xz, -yz, xx + yy),
    ], dim=-2)
    valid = m > 2
    D, info = torch.linalg.solve_ex(torch.where(valid[:, None, None], MM, _eye(7, MM)), MZ)
    ss = (_trace(Pdd) - (D * MZ).sum(-1)) / torch.clamp(2 * m - 3, min=1.0)
    good = valid & (info == 0) & (ss >= 1e-13)
    inv = torch.where(good, 1.0 / torch.where(good, ss, 1.0), 0.0)
    return MM * inv[:, None, None], MZ * inv[:, None]


def _solve(G, B):
    """G X = B in f64 on the device; the minimum-norm solution (the JAX
    package's lstsq fallback) where G is singular."""
    X, info = torch.linalg.solve_ex(G, B)
    if int(info) != 0:
        X = torch.linalg.pinv(G) @ B
    return X


def _assemble(links, valid, Gaa, Gbb, Gab, ra, rb, n_scans: int):
    """Dense system with scan 0 fixed (the FillGB3D pattern,
    lum6Dquat.cc:246-279), scattered on the device: for each valid link
    (f, t) with a = f-1, b = t-1: G[a,a] += Gaa, G[b,b] += Gbb,
    G[a,b] += Gab, G[b,a] += Gabᵀ, rhs[a] += ra, rhs[b] += rb; index -1
    (scan 0) and invalid links go to a dump row that is dropped.
    Returns (G [dof·n, dof·n], rhs [n, k]) f64 (ra, rb: [L, k])."""
    dev = Gaa.device
    dof = Gaa.shape[-1]
    n = n_scans - 1
    lk = torch.as_tensor(np.asarray(links, np.int64).reshape(-1, 2), device=dev)
    a, b = lk[:, 0] - 1, lk[:, 1] - 1
    sa, sb = (a >= 0) & valid, (b >= 0) & valid
    both = sa & sb
    ai, bi = torch.where(sa, a, n), torch.where(sb, b, n)
    abi, bbi = torch.where(both, a, n), torch.where(both, b, n)
    wa, wb, wab = (x.double()[:, None, None] for x in (sa, sb, both))
    Gb = torch.zeros((n + 1, n + 1, dof, dof), dtype=torch.float64, device=dev)
    Rb = torch.zeros((n + 1, ra.shape[-1]), dtype=torch.float64, device=dev)
    Gb.index_put_((ai, ai), Gaa * wa, accumulate=True)
    Gb.index_put_((bi, bi), Gbb * wb, accumulate=True)
    Gb.index_put_((abi, bbi), Gab * wab, accumulate=True)
    Gb.index_put_((bbi, abi), Gab.transpose(-1, -2) * wab, accumulate=True)
    Rb.index_put_((ai,), ra * wa[:, :, 0], accumulate=True)
    Rb.index_put_((bi,), rb * wb[:, :, 0], accumulate=True)
    return Gb[:n, :n].permute(0, 2, 1, 3).reshape(dof * n, dof * n), Rb[:n]


@metrics.time(gs.LUM_RELAX)
def _relax(scans, links, params: LumParams, step) -> float:
    """The iteration shared by the variants (doGraphSlam6D), their whole
    relaxation under the ``lum_relax_time`` timer: raw sums at
    the current poses, then ``step(raw)``, which solves, moves scans
    1..n, writes their LUM frames and returns the summed position
    shift; until the mean shift is <= epsilon or the iterations run out."""
    if len(scans) < 2 or len(links) == 0:
        return 0.0
    ret = np.inf
    it = 0
    while it < params.iterations and ret > params.epsilon:
        with metrics.time(gs.LUM_COV):
            raw = _collect_raw(scans, links, params)
        with metrics.time(gs.LUM_SOLVE):
            shift = step(raw)
        scans[0].add_frame(AlgoType.LUM)
        ret = shift / len(scans)
        it += 1
    return ret


# ---------------------------------------------------------------- quat LUM


def _quat_pose_jacobians(pos, quat):
    """Ha [n,7,7]: d(global point)/d(position, quat) at each pose
    (lum6Dquat.cc:380-416).  pos [n,3], quat [n,4] ([w,x,y,z]) f64."""
    xa, ya, za = pos[:, 0], pos[:, 1], pos[:, 2]
    p, q, r, w = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    px, py, pz = p * xa, p * ya, p * za
    qx, qy, qz = q * xa, q * ya, q * za
    rx, ry, rz = r * xa, r * ya, r * za
    sx, sy, sz = w * xa, w * ya, w * za
    Ha = np.tile(np.eye(7), (len(pos), 1, 1))
    Ha[:, 3:7, 3] = np.stack([2 * p, 2 * q, 2 * r, 2 * w], -1)
    Ha[:, 3:7, 4] = np.stack([2 * q, -2 * p, -2 * w, 2 * r], -1)
    Ha[:, 3:7, 5] = np.stack([2 * r, 2 * w, -2 * p, -2 * q], -1)
    Ha[:, 3:7, 6] = np.stack([2 * w, -2 * r, 2 * q, -2 * p], -1)
    Ha[:, 0:3, 3] = np.stack([-2 * (px + sy - rz), -2 * (-sx + py + qz), -2 * (rx - qy + pz)], -1)
    Ha[:, 0:3, 4] = np.stack([-2 * (qx + ry + sz), -2 * (-rx + qy - pz), -2 * (-sx + py + qz)], -1)
    Ha[:, 0:3, 5] = np.stack([-2 * (rx - qy + pz), -2 * (qx + ry + sz), -2 * (-px - sy + rz)], -1)
    Ha[:, 0:3, 6] = np.stack([-2 * (sx - py - qz), -2 * (px + sy - rz), -2 * (qx + ry + sz)], -1)
    return Ha


def do_graph_slam_quat(scans: list[Scan], links: np.ndarray, params: LumParams) -> float:
    """lum6DQuat::doGraphSlam6D (lum6Dquat.cc:290-477): 7-dof (position +
    unnormalized quaternion) relaxation; the pose update goes through the
    7x7 Jacobian Ha of each scan, and the quaternion is renormalized
    after the additive step.  Mutates poses, writes one LUM frame per
    scan and iteration; returns the final mean position shift."""

    def step(raw):
        C, CD = _quat_link_CCD(raw)
        valid = torch.ones(len(C), dtype=torch.bool, device=C.device)
        G, B = _assemble(links, valid, C, C, -C, CD, -CD, len(scans))
        X = _solve(G, B.reshape(-1)).reshape(-1, 7).cpu().numpy()
        mats = np.stack([s.transMat for s in scans[1:]])
        pos = mats[:, :3, 3]
        quat = math3d.matrix4_to_quat(mats)
        result = np.linalg.solve(_quat_pose_jacobians(pos, quat), X[..., None])[..., 0]
        new_quat = quat - result[:, 3:7]
        new_quat /= np.linalg.norm(new_quat, axis=1, keepdims=True)
        T = math3d.quat_to_matrix4(new_quat, pos - result[:, 0:3])
        for k, s in enumerate(scans[1:]):
            s.set_pose(T[k], AlgoType.LUM)
        return float(np.linalg.norm(result[:, 0:3], axis=1).sum())

    return _relax(scans, links, params, step)


# ---------------------------------------------------------------- ghelix


def _helix_computeRt(ccs: np.ndarray) -> np.ndarray:
    """icp6D_HELIX::computeRt (icp6Dhelix.cc:144-204): helix parameters
    (c; c̄) -> 4x4 alignment, f64."""
    c = -ccs[0:3]
    cs = -ccs[3:6]
    clen = float(np.linalg.norm(c))
    T = np.eye(4)
    if clen < 1e-12:
        # zero-rotation limit of the general formula below: t = cs
        T[:3, 3] = cs
        return T
    angle = np.arctan(clen)
    g = c / clen
    half = -angle / 2.0
    qv = np.concatenate([[np.cos(half)], g * np.sin(half)])
    qv /= np.linalg.norm(qv)
    # the reference builds the transposed quaternion matrix
    R = np.asarray(math3d.quat_to_matrix3(qv)).T
    skew_val = float(c @ cs) / (clen * clen)
    gs_ = (cs - c * skew_val) / clen
    ptemp = np.cross(g, gs_)
    T[:3, :3] = R
    T[:3, 3] = R @ (-ptemp) + g * (skew_val * angle) + ptemp
    return T


def do_graph_slam_helix(scans: list[Scan], links: np.ndarray, params: LumParams) -> float:
    """ghelix6DQ2::doGraphSlam6D (ghelix6DQ2.cc:301-457): one global
    6(n−1) helix system B (c; c̄) = bd per iteration — per link the block
    [tr(Pbb)I − Pbb, skew(sb); skew(sb)ᵀ, mI] from the target (p2) points
    (ghelix6DQ2.cc:124-133) and the right-hand sides (axial(Paa−Pab); Σd)
    and (−axial(Pabᵀ−Pbb); −Σd) — then each scan's helix exponential
    applied as its alignment."""

    def step(raw):
        m, sa, sb = raw["m"], raw["sa"], raw["sb"]
        Paa, Pbb, Pab = raw["Paa"], raw["Pbb"], raw["Pab"]
        Blk = torch.zeros((len(m), 6, 6), dtype=torch.float64, device=m.device)
        Blk[:, :3, :3] = _trace(Pbb)[:, None, None] * _eye(3, Pbb) - Pbb
        Sk = _skew(sb)
        Blk[:, :3, 3:] = Sk
        Blk[:, 3:, :3] = Sk.transpose(-1, -2)
        Blk[:, 3:, 3:] = m[:, None, None] * _eye(3, Pbb)
        sd = sa - sb
        bd1 = torch.cat([_axial(Paa - Pab), sd], -1)  # Σ p1×d ; Σd
        bd2 = torch.cat([-_axial(Pab.transpose(-1, -2) - Pbb), -sd], -1)  # −Σ p2×d ; −Σd
        G, B = _assemble(links, m > 1, Blk, Blk, -Blk, bd1, bd2, len(scans))
        ccs = _solve(G, B.reshape(-1)).cpu().numpy().reshape(-1, 6)
        shift = 0.0
        for k, s in enumerate(scans[1:]):
            T = _helix_computeRt(ccs[k])
            s.transform(T, AlgoType.LUM)
            shift += float(np.linalg.norm(T[:3, 3]))
        return shift

    return _relax(scans, links, params, step)


# ---------------------------------------------------------------- gapx


def _rotvec_matrices(X):
    """exp([θ]×) of rotation vectors X [n,3] (identity below 1e-15 rad),
    f64 tensors [n,3,3]."""
    ang = torch.linalg.norm(X, dim=-1)
    small = ang < 1e-15
    K = _skew(X / torch.where(small, 1.0, ang)[:, None])
    R = (_eye(3, X) + torch.sin(ang)[:, None, None] * K
         + (1 - torch.cos(ang))[:, None, None] * (K @ K))
    return torch.where(small[:, None, None], _eye(3, X), R)


def do_graph_slam_apx(scans: list[Scan], links: np.ndarray, params: LumParams) -> float:
    """gapx6D::doGraphSlam6D (gapx6D.cc:323-545): decoupled global small
    angle relaxation — first a 3(n−1) rotation system over per-link
    centred moments (both sides centred with cm = sa/m, gapx6D.cc:190-196;
    the exact Gauss–Newton blocks for r = d − [p̃1]×θa + [p̃2]×θb), then a
    scan-level Laplacian translation solve with rotated centroids
    (gapx6D.cc:76-140); each scan moves by (exp([θ]×), t)."""

    def step(raw):
        m, sa, sb = raw["m"], raw["sa"], raw["sb"]
        Paa, Pbb, Pab = raw["Paa"], raw["Pbb"], raw["Pab"]
        valid = m > 1
        ms = torch.where(valid, m, 1.0)
        cm, cd = sa / ms[:, None], sb / ms[:, None]
        mm = ms[:, None, None]

        def outer(x, y):
            return x[:, :, None] * y[:, None, :]

        P11 = Paa - outer(sa, sa) / mm
        P22 = Pbb - outer(sb, cm) - outer(cm, sb) + mm * outer(cm, cm)
        P12 = Pab - outer(sa, cm) - outer(cm, sb) + mm * outer(cm, cm)
        I3 = _eye(3, Paa)
        A_aa = _trace(P11)[:, None, None] * I3 - P11
        A_bb = _trace(P22)[:, None, None] * I3 - P22
        A_ab = P12.transpose(-1, -2) - _trace(P12)[:, None, None] * I3
        rhs_a = _axial(P11 - P12.transpose(-1, -2))  # Σ d×p̃1
        rhs_b = -_axial(P12 - P22)  # −Σ d×p̃2
        n_scans = len(scans)
        G, B = _assemble(links, valid, A_aa, A_bb, A_ab, rhs_a, rhs_b, n_scans)
        R = torch.cat([I3[None], _rotvec_matrices(_solve(G, B.reshape(-1)).reshape(-1, 3))])

        # translation: the scan-level Laplacian (gapx6D.cc:76-140)
        lk = torch.as_tensor(np.asarray(links, np.int64).reshape(-1, 2), device=m.device)
        Ak1 = (torch.einsum("lij,lj->li", R[lk[:, 0]], cm)
               - torch.einsum("lij,lj->li", R[lk[:, 1]], cd))
        one = torch.ones((len(m), 1, 1), dtype=torch.float64, device=m.device)
        Bt, At = _assemble(links, valid, one, one, -one, -Ak1, Ak1, n_scans)
        n = n_scans - 1
        t = _solve(Bt, At)  # [n,3]: one Laplacian, three right-hand sides
        align = torch.cat([torch.cat([R[1:], t[:, :, None]], -1),
                           torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64,
                                        device=m.device).expand(n, 1, 4)], 1)
        align = align.cpu().numpy()
        for k, s in enumerate(scans[1:]):
            s.transform(align[k], AlgoType.LUM)
        return float(np.linalg.norm(align[:, :3, 3], axis=1).sum())

    return _relax(scans, links, params, step)


GRAPHSLAM_VARIANTS = {
    2: do_graph_slam_quat,
    3: do_graph_slam_helix,
    4: do_graph_slam_apx,
}
