"""Continuous-time / semi-rigid registration ("srr") — the port of
``tpu3dtk.models.srr``, the reference's ``correction`` pipeline
(src/srr/: continuousreg.cc:109-230, linescan.cc, lum6Deuler.cc (srr
variant)).

The mobile-mapping model: every *line scan* (single scanner revolution)
carries its own pose.  Three stages, as in the reference:

1. **preRegistration** (continuousreg.cc:109-168): join two windows of
   line scans into rigid point clouds, ICP them, then distribute the
   resulting correction linearly (slerp rotation + lerp translation)
   over the line scans between the window representatives
   (linearDistributeError, continuousreg.h:28-99); subsequent line
   scans get the full correction.
2. **SemiRigidRegistration** (continuousreg.cc:180-230): overlapping
   windows (LScan: interval + size + representative), matched pairwise
   through the LUM covariance kernel; per-link 6x6 blocks scatter to
   the *representative line scans'* indices in a 6L x 6L sparse system
   (srr/lum6Deuler.cc FillGB3D), plus odometry chain factors between
   consecutive line scans; solve, update every line-scan pose.
3. Iterate.

On the device: the pre-registration ICP (``icp.icp_pair``, kernel K1 on
a card) and the window covariances (``graphslam.link_covariances``, one
K1 call a link).  On the host, in f64 as in the JAX package: the line
poses, the window point sets, the odometry factors, the sparse 6L solve
(scipy ``spsolve``, CXSparse's role, graphSlam6D.cc:345-366) and the
pose corrections (``graphslam.lum_pose_corrections``).  Odometry factors
use a diagonal weight with the LUM linearization of the pose-delta
residual (the reference derives them from synthetic single-line
covariances with ``odomweight``; equivalent regularization, simplified
parametrization).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import math3d
from ..io.frames import AlgoType
from ..utils.metrics import metrics

__all__ = [
    "LineScanSet",
    "linear_distribute_error",
    "pre_registration",
    "semi_rigid_registration",
    "SrrParams",
]

# metrics counter: window links whose covariances were computed (one
# brute NN call, kernel K1, per link and semi-rigid iteration)
SRR_LINK_CALLS = "srr_link_calls"


def _device(device) -> torch.device:
    if device is None:
        from .. import default_device

        return default_device()
    return torch.device(device)


def _slerp(q0, q1, t):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -np.asarray(q1)
        d = -d
    d = min(1.0, max(-1.0, d))
    th = np.arccos(d)
    if th < 1e-9:
        out = (1 - t) * np.asarray(q0) + t * np.asarray(q1)
    else:
        out = (
            np.sin((1 - t) * th) * np.asarray(q0) + np.sin(t * th) * np.asarray(q1)
        ) / np.sin(th)
    return out / np.linalg.norm(out)


@dataclasses.dataclass
class LineScanSet:
    """All line scans of a trajectory: padded points + per-line poses."""

    points: np.ndarray  # [L, P, 3] f32 local frame
    masks: np.ndarray  # [L, P] bool
    poses: np.ndarray  # [L, 4, 4] current transMat per line
    poses_org: np.ndarray  # [L, 4, 4] odometry poses (transMatOrg)
    frames: list = dataclasses.field(default_factory=list)  # pose log

    @classmethod
    def from_lists(cls, point_lists, poses):
        L = len(point_lists)
        P = max((len(p) for p in point_lists), default=1)
        P = max(P, 1)
        pts = np.zeros((L, P, 3), np.float32)
        msk = np.zeros((L, P), bool)
        for i, p in enumerate(point_lists):
            pts[i, : len(p)] = p
            msk[i, : len(p)] = True
        poses = np.asarray(poses, np.float64)
        return cls(points=pts, masks=msk, poses=poses.copy(), poses_org=poses.copy())

    @property
    def n(self) -> int:
        return len(self.points)

    def global_window(self, begin: int, end: int) -> np.ndarray:
        """Concatenated global-frame points of lines [begin, end]
        (ref joinLines, continuousreg.cc), f32."""
        begin = max(0, begin)
        end = min(self.n - 1, end)
        chunks = [
            math3d.transform3(self.poses[i], self.points[i][self.masks[i]], xp=np)
            for i in range(begin, end + 1)
        ]
        return np.concatenate(chunks, axis=0).astype(np.float32)

    def record(self, algo: AlgoType) -> None:
        self.frames.append((self.poses.copy(), int(algo)))


def linear_distribute_error(
    ls: LineScanSet, begin: int, end: int, T_new_end: np.ndarray
) -> None:
    """Distribute the correction ``T_new_end · inv(poses[end])`` over
    lines (begin, end] by slerp/lerp fraction; lines after ``end`` get
    the full correction (ref continuousreg.h:28-99)."""
    length = max(end - begin, 1)
    T_old = ls.poses[end]
    diff = np.asarray(T_new_end, np.float64) @ math3d.m4inv(T_old, xp=np)
    q_diff = math3d.matrix4_to_quat(diff, xp=np)
    t_diff = diff[:3, 3]
    q_id = np.array([1.0, 0, 0, 0])
    for i in range(begin, end + 1):
        t = (i - begin) / length
        qi = _slerp(q_id, q_diff, t)
        Ti = math3d.quat_to_matrix4(qi, t_diff * t, xp=np)
        ls.poses[i] = Ti @ ls.poses[i]
    for i in range(end + 1, ls.n):
        ls.poses[i] = diff @ ls.poses[i]


def _padded(p: np.ndarray, cap: int):
    out = np.zeros((cap, 3), np.float32)
    out[: len(p)] = p
    m = np.zeros(cap, bool)
    m[: len(p)] = True
    return out, m


def _cap512(n: int) -> int:
    return ((n + 511) // 512) * 512


def pre_registration(
    ls: LineScanSet,
    first: tuple[int, int],
    last: tuple[int, int],
    *,
    max_dist_match2: float = 2500.0,
    max_iterations: int = 60,
    epsilon: float = 1e-6,
    device=None,
) -> int:
    """Rigid ICP of the joined `last` window against the joined `first`
    window on ``device`` (None: the first card), correction distributed
    along the trajectory (ref preRegistration, continuousreg.cc:109-168).
    Returns the ICP iterations."""
    from . import icp as icp_mod

    dev = _device(device)
    fe, fl = first
    le, ll = last
    findex = fe + (fl - fe) // 2
    lindex = le + (ll - le) // 2
    model = ls.global_window(fe, fl)
    target = ls.global_window(le, ll)
    mp, mm = _padded(model, _cap512(len(model)))
    tp, tm = _padded(target, _cap512(len(target)))
    res = icp_mod.icp_pair(
        torch.as_tensor(mp, device=dev), torch.as_tensor(mm, device=dev),
        torch.as_tensor(tp, device=dev), torch.as_tensor(tm, device=dev),
        torch.eye(4, dtype=torch.float32, device=dev),
        max_dist_match2=max_dist_match2,
        epsilon=epsilon,
        max_iterations=max_iterations,
    )
    align = res.T.cpu().numpy().astype(np.float64)
    u, _, vt = np.linalg.svd(align[:3, :3])
    align[:3, :3] = u @ vt
    # new pose of the last window's representative line
    T_new = align @ ls.poses[lindex]
    linear_distribute_error(ls, findex, lindex, T_new)
    ls.record(AlgoType.ICP)
    return int(res.iterations)


@dataclasses.dataclass
class SrrParams:
    scaninterval: int = 10  # lines between window representatives
    scansize: int = 10  # half-window in lines
    iterations: int = 3  # outer semi-rigid iterations
    lum_max_dist2: float = 2500.0
    odom_weight: float = 10.0  # consecutive-line odometry factor weight
    cldist: float = 750.0  # proximity links between representatives
    loopsize: int = 3  # in windows
    epsilon: float = 0.05


def _window_links(rep_pos: np.ndarray, loopsize: int, cldist: float) -> list:
    """Consecutive windows plus proximity links between representatives
    more than ``loopsize`` windows apart and closer than ``cldist``."""
    W = len(rep_pos)
    links = [(i, i + 1) for i in range(W - 1)]
    d2m = ((rep_pos[:, None] - rep_pos[None]) ** 2).sum(-1)
    for i in range(W):
        for j in range(i + 1, W):
            if (j - i) > loopsize and d2m[i, j] < cldist**2:
                links.append((i, j))
    return links


def semi_rigid_registration(ls: LineScanSet, params: SrrParams, device=None) -> float:
    """Deform the trajectory: overlapping windows matched via the LUM
    covariance kernel on ``device`` (None: the first card), scattered
    into a 6L sparse system with odometry chain factors, solved on the
    host and applied to every line scan (ref SemiRigidRegistration,
    continuousreg.cc:180-230 + srr/lum6Deuler.cc doGraphSlam6D).
    Returns the last iteration's mean position correction."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from .graphslam import link_covariances, lum_pose_corrections

    dev = _device(device)
    L = ls.n
    reps = list(range(0, L, params.scaninterval))
    if reps[-1] != L - 1:
        reps.append(L - 1)
    windows = [
        (max(0, r - params.scansize), min(L - 1, r + params.scansize), r)
        for r in reps
    ]
    ret = np.inf
    it = 0
    while it < params.iterations and ret > params.epsilon:
        # window point sets (global frame, padded uniformly)
        pts_list = [ls.global_window(b, e) for b, e, _ in windows]
        cap = _cap512(max(len(p) for p in pts_list))
        W = len(windows)
        pts = np.zeros((W, cap, 3), np.float32)
        msk = np.zeros((W, cap), bool)
        for i, p in enumerate(pts_list):
            pts[i, : len(p)] = p
            msk[i, : len(p)] = True
        rep_pos = np.stack([ls.poses[r][:3, 3] for _, _, r in windows])
        links = _window_links(rep_pos, params.loopsize, params.cldist)
        C, CD, _m = link_covariances(
            torch.as_tensor(pts, device=dev), torch.as_tensor(msk, device=dev),
            np.asarray(links, np.int64), params.lum_max_dist2,
        )
        metrics.count(SRR_LINK_CALLS, len(links))
        C = C.cpu().numpy().astype(np.float64)
        CD = CD.cpu().numpy().astype(np.float64)

        n = L - 1
        rowsG, colsG, valsG = [], [], []
        B = np.zeros(6 * n)
        r6, c6 = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")

        def add_block(a, b, M):
            rowsG.append((a * 6 + r6).ravel())
            colsG.append((b * 6 + c6).ravel())
            valsG.append(M.ravel())

        def fill(a, b, Cab, CDab):
            # _fillGB semantics (scan 0 fixed): a, b are line indices - 1
            if a >= 0:
                B[a * 6 : a * 6 + 6] += CDab
                add_block(a, a, Cab)
            if b >= 0:
                B[b * 6 : b * 6 + 6] -= CDab
                add_block(b, b, Cab)
            if a >= 0 and b >= 0:
                add_block(a, b, -Cab)
                add_block(b, a, -Cab)

        for li, (wi, wj) in enumerate(links):
            fill(windows[wi][2] - 1, windows[wj][2] - 1, C[li], CD[li])

        # odometry chain factors between consecutive lines: residual =
        # (current delta) - (odometry delta) in the LUM linearization
        wI = params.odom_weight * np.eye(6)
        for i in range(1, L):
            cur = math3d.m4inv(ls.poses[i - 1], xp=np) @ ls.poses[i]
            odo = math3d.m4inv(ls.poses_org[i - 1], xp=np) @ ls.poses_org[i]
            ddiff = cur @ math3d.m4inv(odo, xp=np)
            th, po = math3d.matrix4_to_euler(ddiff, xp=np)
            fill(i - 2, i - 1, wI, wI @ np.concatenate([po, th]))

        G = sp.coo_matrix(
            (np.concatenate(valsG), (np.concatenate(rowsG), np.concatenate(colsG))),
            shape=(6 * n, 6 * n),
        ).tocsc()
        # tiny Tikhonov keeps rank when a line has no constraints
        G = G + sp.identity(6 * n, format="csc") * 1e-6
        X = spla.spsolve(G, B).reshape(-1, 6)

        # batched LUM pose correction through the Ha Jacobian
        theta, pos = math3d.matrix4_to_euler(ls.poses[1:], xp=np)
        res = lum_pose_corrections(pos, theta, X)
        ls.poses[1:] = math3d.euler_to_matrix4(pos - res[:, :3], theta - res[:, 3:], xp=np)
        sum_diff = float(np.linalg.norm(res[:, :3], axis=1).sum())
        ls.record(AlgoType.LUM)
        ret = sum_diff / L
        it += 1
    return ret
