"""GraphSLAM — globally consistent Lu/Milios-style 6-DoF relaxation
("LUM"), the port of the host path of ``tpu3dtk/models/graphslam.py``
(the reference's ``lum6DEuler``, src/slam6d/lum6Deuler.cc:94-477).

Math (identical to the reference and the JAX package):

Per graph link (i, j), with point pairs (a_k from scan i, b_k from scan
j, both in the current global frame):
    mid = (a+b)/2,  d = a-b
    MZ  = [Σd ; Σ(-z·dy + y·dz) ; Σ(-y·dx + x·dy) ; Σ(z·dx - x·dz)]
    MM  = the 6x6 Gram matrix of the linearized pose observation
    D   = MM⁻¹ MZ,  ss = Σ‖residual(D)‖² / (2m-3)
    C   = MM/ss,  CD = MZ/ss            (lum6Deuler.cc:141-232)

Assembly (FillGB3D, lum6Deuler.cc:265-303): for link (a, b) with scan 0
fixed,  B[a] += CD, B[b] -= CD, G[aa] += C, G[bb] += C, G[ab] -= C,
G[ba] -= C.  Solve G X = B, then per scan the pose correction is
Ha⁻¹ X_i subtracted from the Euler pose (lum6Deuler.cc:375-455).

Counterparts in ``tpu3dtk/models/graphslam.py``: :func:`read_net_graph`,
:func:`lum_pair_stats`, :func:`link_covariances` (brute NN, kernel K1
per link), :func:`link_covariances_chained` (cell-list NN, kernel K2 per
link), :func:`assemble_GB`, ``_solve_GX_B`` (dense f64 branch),
:func:`lum_pose_corrections`, :class:`LumParams` (the fields this path
reads, plus ``device``), ``_do_graph_slam_host`` and
:func:`do_graph_slam`, which always takes the host path here: the
on-device relaxation (``lum_device.lum_run``), the correspondence cache
and the proximity / clpairs graph constructors are not ported yet.

The JAX package gates the chained covariance engine on a TPU backend;
the port gates on the scan size alone (``chained_min``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import math3d
from ..core.scan import Scan
from ..io.frames import AlgoType
from ..ops import nn as nn_ops
from ..utils.metrics import metrics

__all__ = [
    "LumParams", "assemble_GB", "do_graph_slam", "link_covariances",
    "link_covariances_chained", "lum_pair_stats", "lum_pose_corrections",
    "read_net_graph",
]

# metrics counter: NN calls of the chained covariance engine (one
# cell-list NN call per link and LUM iteration)
CHAINED_LINK_CALLS = "chained_lum_link_calls"
LUM_COV = "lum_cov_time"
LUM_SOLVE = "lum_solve_time"


def read_net_graph(path: str) -> np.ndarray:
    """Explicit pose-graph file: first line = #scans, second = #links,
    then one 'from to' pair per line (ref Graph::Graph(netfile),
    src/slam6d/graph.cc:53-75; used by the bremen_city config's
    ``-n bremen.net``).  Returns links [L, 2] int32."""
    with open(path) as f:
        tokens = f.read().split()
    n_scans = int(tokens[0])
    n_links = int(tokens[1])
    vals = list(map(int, tokens[2 : 2 + 2 * n_links]))
    links = np.asarray(vals, np.int32).reshape(-1, 2)
    if links.max(initial=0) >= n_scans:
        raise ValueError(f"{path}: link index beyond {n_scans} scans")
    return links


def lum_pair_stats(a, b, found):
    """The LUM link covariance math from matched global-frame pairs:
    C (6,6), CD (6,), m — the MZ/MM sums, D solve and residual variance
    of covarianceEuler (lum6Deuler.cc:141-232).  a: matched model
    points [N,3]; b: target points [N,3]; found: accept mask [N].  f32
    tensors on the inputs' device."""
    w = found.to(torch.float32)
    m = w.sum()

    mid = 0.5 * (a + b)
    d = a - b
    x, y, z = mid[:, 0], mid[:, 1], mid[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

    def s(v):
        return (w * v).sum()

    MZ = torch.stack(
        [
            s(dx),
            s(dy),
            s(dz),
            s(-z * dy + y * dz),
            s(-y * dx + x * dy),
            s(z * dx - x * dz),
        ]
    )
    sx, sy, sz = s(x), s(y), s(z)
    xpy = s(x * x + y * y)
    xpz = s(x * x + z * z)
    ypz = s(y * y + z * z)
    xy, xz, yz = s(x * y), s(x * z), s(y * z)
    o = torch.zeros_like(m)
    MM = torch.stack(
        [
            torch.stack([m, o, o, o, -sy, sz]),
            torch.stack([o, m, o, -sz, sx, o]),
            torch.stack([o, o, m, sy, o, -sx]),
            torch.stack([o, -sz, sy, ypz, -xz, -xy]),
            torch.stack([-sy, sx, o, -xz, xpy, -yz]),
            torch.stack([sz, o, -sx, -xy, -yz, xpz]),
        ]
    )
    ok = m > 2
    eye6 = torch.eye(6, dtype=MM.dtype, device=MM.device)
    MMr = torch.where(ok, MM, eye6)
    D = torch.linalg.solve(MMr, MZ)
    # residual variance (lum6Deuler.cc:196-215)
    rx = dx - (D[0] - y * D[4] + z * D[5])
    ry = dy - (D[1] - z * D[3] + x * D[4])
    rz = dz - (D[2] + y * D[3] - x * D[5])
    ss = s(rx * rx + ry * ry + rz * rz) / torch.clamp(2 * m - 3, min=1.0)
    good = ok & (ss >= 1e-13)
    inv_ss = torch.where(good, 1.0 / torch.clamp(ss, min=1e-13), 0.0)
    C = torch.where(good, MM * inv_ss, 0.0)
    CD = torch.where(good, MZ * inv_ss, 0.0)
    return C, CD, m


def link_covariances(points_g, masks, links, max_dist2):
    """(C, CD, m) for all links through the brute NN engine (kernel K1
    per link on the card).

    points_g: [S, N, 3] f32 global-frame reduced points per scan; masks:
    [S, N]; links: [L, 2].  Pairs of link (i, j) are the NN of scan j's
    points among scan i's (Scan::getPtPairs convention, the link order
    used in FillGB3D).  Returns tensors C [L,6,6], CD [L,6], m [L]."""
    max_dist2 = float(np.float32(max_dist2))
    outs = []
    for i, j in np.asarray(links).tolist():
        idx, _d2, found = nn_ops.nn_brute_auto(
            points_g[j], masks[j], points_g[i], masks[i], max_dist2
        )
        outs.append(lum_pair_stats(points_g[i][idx], points_g[j], found))
    return (
        torch.stack([o[0] for o in outs]),
        torch.stack([o[1] for o in outs]),
        torch.stack([o[2] for o in outs]),
    )


def link_covariances_chained(points_g, masks, links, max_dist2, spec):
    """(C, CD, m) for all links through the cell-list chain (kernel K2)
    — the city-scale LUM covariance engine (bremen regime: ~300k reduced
    points per scan, where brute costs ~10¹¹ pairs per link).  Per link,
    the sorted cell-list model of scan i's global points is built once
    and the chained NN runs for scan j's points; every op is queued
    before the single packed read at the end.

    ``spec`` comes from ``ops.nn_cell_list.cell_list_spec`` sized over
    the whole sequence's global clouds.  Returns numpy (C [L,6,6], CD
    [L,6], m [L], guard_fired: bool) — on guard (lane overflow /
    out-of-box) the caller should retry with a larger-headroom spec.
    """
    from ..ops import nn_cell_list as ncl

    perm = tuple(spec.get("perm", (0, 1, 2)))
    max_dist = float(np.sqrt(max_dist2))
    md2 = float(np.float32(max_dist2))
    models = {}
    packed = []
    guards = []
    for i, j in np.asarray(links).tolist():
        if i not in models:
            models[i] = ncl.build_cell_list_model(
                points_g[i], masks[i], spec["origin"], max_dist,
                dims=spec["dims"], RB=spec["RB"], perm=perm,
            )
        clm, oob_m = models[i]
        # RB=None: unclamped table, no overflow lane (see icp_pair_chained)
        idx, _d2, found, overflow, oob_q = ncl.nn_cell_list_chained(
            points_g[j], masks[j], clm, md2,
            dims=spec["dims"], RB=None, chunk=spec["chunk"], perm=perm,
        )
        metrics.count(CHAINED_LINK_CALLS)
        C, CD, m = lum_pair_stats(points_g[i][idx], points_g[j], found)
        packed.append(torch.cat([C.reshape(36), CD, m[None]]))
        guards.append(overflow.to(torch.int32) + oob_q + oob_m)
    L = len(packed)
    guard = torch.stack(guards).sum().to(torch.float32)
    flat = torch.cat([torch.stack(packed).reshape(-1), guard[None]])
    flat = flat.cpu().numpy()  # the one device->host read
    rows = flat[:-1].reshape(L, 43)
    return (
        rows[:, :36].reshape(L, 6, 6),
        rows[:, 36:42],
        rows[:, 42],
        bool(flat[-1] > 0),
    )


def assemble_GB(links: np.ndarray, C: np.ndarray, CD: np.ndarray, n_scans: int):
    """Dense G (6n x 6n), B (6n) with scan 0 fixed (FillGB3D,
    lum6Deuler.cc:265-303).  f64 host assembly (tiny)."""
    n = n_scans - 1
    C = np.asarray(C, np.float64)
    CD = np.asarray(CD, np.float64)
    lk = np.asarray(links, np.int64)
    a = lk[:, 0] - 1
    b = lk[:, 1] - 1
    # block form [n,n,6,6] scattered with np.add.at, then reshaped
    Gb = np.zeros((n, n, 6, 6))
    Bb = np.zeros((n, 6))
    sa, sb = a >= 0, b >= 0
    np.add.at(Bb, a[sa], CD[sa])
    np.add.at(Bb, b[sb], -CD[sb])
    np.add.at(Gb, (a[sa], a[sa]), C[sa])
    np.add.at(Gb, (b[sb], b[sb]), C[sb])
    both = sa & sb
    np.add.at(Gb, (a[both], b[both]), -C[both])
    np.add.at(Gb, (b[both], a[both]), -C[both])
    G = Gb.transpose(0, 2, 1, 3).reshape(6 * n, 6 * n)
    return G, Bb.reshape(6 * n)


def lum_pose_corrections(poses_pos, poses_theta, X):
    """Ha⁻¹ X per scan (lum6Deuler.cc:375-436).  poses_*: [n,3] for
    scans 1..n (scan 0 fixed); X: [n,6].  Returns result [n,6] to be
    subtracted from (pos, theta).  Host numpy f64, batched: the systems
    are 6x6 per scan and the pose update wants full f64."""
    pos = np.asarray(poses_pos, np.float64)
    theta = np.asarray(poses_theta, np.float64)
    X = np.asarray(X, np.float64)
    n = len(X)
    xa, ya, za = pos[:, 0], pos[:, 1], pos[:, 2]
    tx, ty = theta[:, 0], theta[:, 1]
    ctx, stx = np.cos(tx), np.sin(tx)
    cty, sty = np.cos(ty), np.sin(ty)
    Ha = np.tile(np.eye(6), (n, 1, 1))
    Ha[:, 0, 4] = -za * ctx + ya * stx
    Ha[:, 0, 5] = ya * cty * ctx + za * stx * cty
    Ha[:, 1, 3] = za
    Ha[:, 1, 4] = -xa * stx
    Ha[:, 1, 5] = -xa * ctx * cty + za * sty
    Ha[:, 2, 3] = -ya
    Ha[:, 2, 4] = xa * ctx
    Ha[:, 2, 5] = -xa * cty * stx - ya * sty
    Ha[:, 3, 5] = sty
    Ha[:, 4, 4] = stx
    Ha[:, 4, 5] = ctx * cty
    Ha[:, 5, 4] = ctx
    Ha[:, 5, 5] = -stx * cty
    return np.linalg.solve(Ha, X[..., None])[..., 0]


@dataclasses.dataclass
class LumParams:
    max_dist_match2: float = 625.0  # -D distSLAM squared
    iterations: int = 50  # -I iterSLAM
    epsilon: float = 0.5  # --epsSLAM (mean position shift, cm)
    pad_multiple: int = 512
    # dense f64 solve up to this many scans (the block-CG solver for
    # larger graphs is not ported yet)
    dense_solver_max_scans: int = 65
    # scans padded to this many points or more route their covariances
    # through the cell-list chain (link_covariances_chained): O(occupancy)
    # per query instead of the brute O(M) per query
    chained_min: int = 98304
    device: torch.device | str | None = None  # None: the package default


def _solve_GX_B(
    scans_n: int, links: np.ndarray, C: np.ndarray, CD: np.ndarray,
    dense_max: int,
) -> np.ndarray:
    """Solve the LUM system, dense in f64."""
    if scans_n > dense_max:
        raise NotImplementedError(
            f"LUM over {scans_n} scans needs the block-CG solver, which is "
            "not ported yet (ROADMAP slice C: pgsolve); the dense solve "
            f"covers up to {dense_max} scans"
        )
    G, B = assemble_GB(links, C, CD, scans_n)
    try:
        return np.linalg.solve(G, B).reshape(-1, 6)
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(G, B, rcond=None)[0].reshape(-1, 6)


def _pad_scan_points(scans, cap):
    locals_pad = np.zeros((len(scans), cap, 3), np.float32)
    masks = np.zeros((len(scans), cap), bool)
    for si, s in enumerate(scans):
        r = s.reduced_local()
        locals_pad[si, : len(r)] = r
        masks[si, : len(r)] = True
    return locals_pad, masks


def do_graph_slam(
    scans: list[Scan], links: np.ndarray, params: LumParams
) -> float:
    """Run LUM iterations until mean pose shift < epsilon
    (doGraphSlam6D, lum6Deuler.cc:314-477).  Mutates scan poses; writes
    LUM-tagged frames (one per iteration, scan.cc:918-1009).  Returns
    final mean position shift.  Always the host-orchestrated loop here
    (the JAX package also has an all-on-device relaxation)."""
    if len(scans) < 2 or len(links) == 0:
        return 0.0
    return _do_graph_slam_host(scans, links, params)


def _link_spec(clouds, links, max_dist, headroom):
    from ..ops import nn_cell_list as ncl

    return ncl.cell_list_spec(
        np.concatenate(clouds), max_dist, headroom=headroom,
        model_sets=clouds, queries=clouds,
        pairs=[(int(i), int(j)) for i, j in np.asarray(links)],
    )


def _do_graph_slam_host(
    scans: list[Scan], links: np.ndarray, params: LumParams
) -> float:
    """Host-orchestrated LUM: per iteration the link covariances on the
    device and the f64 solve and pose update on the host."""
    if params.device is None:
        from .. import default_device

        dev = default_device()
    else:
        dev = torch.device(params.device)
    cap = max(len(s.reduced_local()) for s in scans)
    cap = ((cap + params.pad_multiple - 1) // params.pad_multiple) * params.pad_multiple
    locals_pad, masks = _pad_scan_points(scans, cap)
    locals_t = torch.as_tensor(locals_pad, device=dev)
    masks_t = torch.as_tensor(masks, device=dev)
    max_dist = float(np.sqrt(params.max_dist_match2))

    chain_spec = None
    if cap >= params.chained_min:
        clouds = [
            np.asarray(
                math3d.transform3(s.transMat, s.reduced_local()), np.float32
            )
            for s in scans
        ]
        chain_spec = _link_spec(clouds, links, max_dist, 2.0)

    ret = np.inf
    it = 0
    while it < params.iterations and ret > params.epsilon:
        mats = torch.as_tensor(
            np.stack([s.transMat for s in scans]).astype(np.float32), device=dev
        )
        points_g = (
            torch.einsum("sij,snj->sni", mats[:, :3, :3], locals_t)
            + mats[:, None, :3, 3]
        ).contiguous()
        with metrics.time(LUM_COV):
            if chain_spec is not None:
                C, CD, _m, guard = link_covariances_chained(
                    points_g, masks_t, links, params.max_dist_match2,
                    chain_spec,
                )
                if guard:
                    # lane overflow / box exit: re-spec from the CURRENT
                    # global clouds with double headroom
                    pts_host = points_g.cpu().numpy()
                    clouds = [
                        pts_host[i][masks[i]] for i in range(len(scans))
                    ]
                    chain_spec = _link_spec(clouds, links, max_dist, 4.0)
                    if chain_spec is not None:
                        C, CD, _m, guard = link_covariances_chained(
                            points_g, masks_t, links,
                            params.max_dist_match2, chain_spec,
                        )
            if chain_spec is None:
                C, CD, _m = link_covariances(
                    points_g, masks_t, links, params.max_dist_match2
                )
                C, CD = C.cpu().numpy(), CD.cpu().numpy()
        with metrics.time(LUM_SOLVE):
            X = _solve_GX_B(
                len(scans), links, C, CD, params.dense_solver_max_scans
            )
        pos = np.stack([s.rPos for s in scans[1:]])
        theta = np.stack([s.rPosTheta for s in scans[1:]])
        result = lum_pose_corrections(pos, theta, X)
        sum_position_diff = 0.0
        for k, s in enumerate(scans[1:]):
            new_pos = pos[k] - result[k, :3]
            new_theta = theta[k] - result[k, 3:]
            T = np.asarray(math3d.euler_to_matrix4(new_pos, new_theta, xp=np))
            s.set_pose(T, AlgoType.LUM)
            sum_position_diff += float(np.linalg.norm(result[k, :3]))
        scans[0].add_frame(AlgoType.LUM)
        ret = sum_position_diff / len(scans)
        it += 1
    return ret
