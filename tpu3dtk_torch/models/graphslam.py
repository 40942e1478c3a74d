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
:func:`build_proximity_graph`, :func:`build_clpairs_graph`,
:func:`lum_pair_stats`, :func:`link_covariances` (brute NN, kernel K1
per link), :func:`link_covariances_global` (the same from resident
local-frame tensors and a pose stack), :func:`link_covariances_chained`
(cell-list NN, kernel K2 per link), :func:`assemble_GB`, ``_solve_GX_B``
(dense f64, block-CG above ``dense_solver_max_scans``),
:func:`lum_pose_corrections`, :class:`LumParams`, ``_do_graph_slam_host``
and :func:`do_graph_slam`: scans of fewer than ``chained_min`` points
relax on the device (``lum_device.lum_run``, or one cached step through
``lum_device.lum_step_cached``), with a dense solve while the system
fits in half the device's free memory and the device block-CG beyond;
city-scale scans take the host loop with chained covariances.  The JAX
package sends graphs of more than ``device_max_scans`` (512) scans to
the host loop instead; here they stay on the device.

The JAX package gates the chained covariance engine on a TPU backend;
the port gates on the scan size alone (``chained_min``).  Shape
bucketing (``scan_cap``, ``link_cap_min``, ``point_cap``) has no
counterpart: eager PyTorch compiles nothing, so links are not padded.
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
from .sequence import _PAD, _round_up

__all__ = [
    "LumParams", "assemble_GB", "build_clpairs_graph", "build_proximity_graph",
    "do_graph_slam", "global_points", "link_covariances",
    "link_covariances_chained", "link_covariances_global", "lum_pair_stats",
    "lum_pose_corrections", "read_net_graph",
]

# metrics counter: NN calls of the chained covariance engine (one
# cell-list NN call per link and LUM iteration)
CHAINED_LINK_CALLS = "chained_lum_link_calls"
# metrics counter: brute NN calls of the relaxation (one call, kernel
# K1, per link and LUM iteration: the on-device relaxation, and the host
# path where no cell-list spec fits)
LUM_LINK_CALLS = "lum_link_calls"
# metrics counter: brute NN calls (kernel K1) of build_clpairs_graph,
# one per candidate link
CLPAIRS_LINK_CALLS = "clpairs_link_calls"
# metrics timers (host clocks; on the device path the solve span ends
# with the iteration's host read, so it also waits for whatever of the
# covariance kernels is still queued)
LUM_COV = "lum_cov_time"
LINK_CHUNK = 64  # links whose pair statistics are reduced in one batch
LUM_SOLVE = "lum_solve_time"
# metrics timer: a whole relaxation, do_graph_slam or a variant of
# models.graphslam_variants (padding, upload, spec, covariances, solves)
LUM_RELAX = "lum_relax_time"


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


def build_proximity_graph(
    positions: np.ndarray, cldist2: float, loopsize: int
) -> np.ndarray:
    """Links = consecutive chain + all (j,k), |k-j| > loopsize, with pose
    distance² < cldist2 (ref Graph::Graph(int,double,int),
    src/slam6d/graph.cc:108-130).  positions: [S,3].  Returns [L,2] int."""
    S = len(positions)
    chain = np.stack(
        [np.arange(S - 1), np.arange(1, S)], axis=1
    ) if S > 1 else np.zeros((0, 2), np.int64)
    d2 = ((positions[:, None, :] - positions[None, :, :]) ** 2).sum(-1)
    jj, kk = np.triu_indices(S, k=1)
    sel = ((kk - jj) > loopsize) & (d2[jj, kk] < cldist2)
    extra = np.stack([jj[sel], kk[sel]], axis=1)
    return np.concatenate([chain, extra]).astype(np.int32)


def build_clpairs_graph(
    scans, max_dist2: float, min_pairs: int, device=None
) -> np.ndarray:
    """Links = all scan pairs sharing >= min_pairs NN point pairs at
    the current poses (ref graphSlam6D::computeGraph6Dautomatic,
    src/slam6d/graphSlam6D.cc:136-200, the ``-C/--clpairs`` graph).

    Candidates are pre-filtered by bounding-sphere overlap so the O(S²)
    NN work only runs where geometry can overlap; the pairs of every
    candidate link are counted by one brute NN call each (kernel K1).
    Returns links [L, 2] int32."""
    dev = _resolve_device(device)
    S = len(scans)
    cap = _round_up(max(len(s.reduced_local()) for s in scans), _PAD)
    locals_pad, masks = _pad_scan_points(scans, cap)
    mats = np.stack([s.transMat for s in scans]).astype(np.float32)
    # bounding-sphere prefilter in the global frame
    centers = np.zeros((S, 3))
    radii = np.zeros(S)
    for si, s in enumerate(scans):
        g = np.asarray(math3d.transform3(s.transMat, s.reduced_local()))
        centers[si] = g.mean(axis=0)
        radii[si] = np.linalg.norm(g - centers[si], axis=1).max()
    jj, kk = np.triu_indices(S, k=1)
    dist = np.linalg.norm(centers[jj] - centers[kk], axis=1)
    near = dist <= radii[jj] + radii[kk] + float(np.sqrt(max_dist2))
    cand = np.stack([jj[near], kk[near]], axis=1).astype(np.int32)
    if len(cand) == 0:
        return np.zeros((0, 2), np.int32)
    _C, _CD, m = link_covariances_global(
        torch.as_tensor(locals_pad, device=dev),
        torch.as_tensor(masks, device=dev),
        torch.as_tensor(mats, device=dev), cand, max_dist2,
    )
    metrics.count(CLPAIRS_LINK_CALLS, len(cand))
    return cand[m.cpu().numpy() >= min_pairs]


def lum_pair_stats(a, b, found):
    """The LUM link covariance math from matched global-frame pairs:
    C (6,6), CD (6,), m — the MZ/MM sums, D solve and residual variance
    of covarianceEuler (lum6Deuler.cc:141-232).  a: matched model
    points [N,3]; b: target points [N,3]; found: accept mask [N].  f32
    tensors on the inputs' device.  Leading batch dimensions (one row
    per link: a, b [L,N,3], found [L,N]) give C [L,6,6], CD [L,6], m [L]."""
    w = found.to(torch.float32)
    m = w.sum(-1)

    mid = 0.5 * (a + b)
    d = a - b
    x, y, z = mid[..., 0], mid[..., 1], mid[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    def s(v):
        return (w * v).sum(-1)

    def row(*v):
        return torch.stack(v, dim=-1)

    MZ = row(
        s(dx),
        s(dy),
        s(dz),
        s(-z * dy + y * dz),
        s(-y * dx + x * dy),
        s(z * dx - x * dz),
    )
    sx, sy, sz = s(x), s(y), s(z)
    xpy = s(x * x + y * y)
    xpz = s(x * x + z * z)
    ypz = s(y * y + z * z)
    xy, xz, yz = s(x * y), s(x * z), s(y * z)
    o = torch.zeros_like(m)
    MM = torch.stack(
        [
            row(m, o, o, o, -sy, sz),
            row(o, m, o, -sz, sx, o),
            row(o, o, m, sy, o, -sx),
            row(o, -sz, sy, ypz, -xz, -xy),
            row(-sy, sx, o, -xz, xpy, -yz),
            row(sz, o, -sx, -xy, -yz, xpz),
        ],
        dim=-2,
    )
    ok = m > 2
    eye6 = torch.eye(6, dtype=MM.dtype, device=MM.device)
    MMr = torch.where(ok[..., None, None], MM, eye6)
    D = torch.linalg.solve(MMr, MZ[..., None])  # [..., 6, 1]
    # residual variance (lum6Deuler.cc:196-215)
    rx = dx - (D[..., 0, :] - y * D[..., 4, :] + z * D[..., 5, :])
    ry = dy - (D[..., 1, :] - z * D[..., 3, :] + x * D[..., 4, :])
    rz = dz - (D[..., 2, :] + y * D[..., 3, :] - x * D[..., 5, :])
    ss = s(rx * rx + ry * ry + rz * rz) / torch.clamp(2 * m - 3, min=1.0)
    good = ok & (ss >= 1e-13)
    inv_ss = torch.where(good, 1.0 / torch.clamp(ss, min=1e-13), 0.0)
    C = torch.where(good[..., None, None], MM * inv_ss[..., None, None], 0.0)
    CD = torch.where(good[..., None], MZ * inv_ss[..., None], 0.0)
    return C, CD, m


def global_points(locals_pts, mats):
    """Resident local-frame points [S,N,3] under the pose stack
    [S,4,4]: the global-frame clouds [S,N,3] f32, on the device."""
    mats = mats.to(torch.float32)
    return (
        torch.einsum("sij,snj->sni", mats[:, :3, :3], locals_pts)
        + mats[:, None, :3, 3]
    ).contiguous()


def gather_pairs(points_g, links_t, idx):
    """Matched pairs of a batch of links: links_t [L,2] int64 tensor,
    idx [L,N] each link's neighbour indices into scan i.  Returns
    (a [L,N,3] scan i's matched points, b [L,N,3] scan j's points)."""
    S, N, _ = points_g.shape
    flat = points_g.reshape(S * N, 3)
    return flat[links_t[:, :1] * N + idx], points_g[links_t[:, 1]]


def link_covariances(points_g, masks, links, max_dist2):
    """(C, CD, m) for all links through the brute NN engine (kernel K1
    per link on the card).

    points_g: [S, N, 3] f32 global-frame reduced points per scan; masks:
    [S, N]; links: [L, 2].  Pairs of link (i, j) are the NN of scan j's
    points among scan i's (Scan::getPtPairs convention, the link order
    used in FillGB3D).  One NN call per link; the statistics are reduced
    for ``LINK_CHUNK`` links together, which bounds the [chunk, N, 3]
    gathers.  Returns tensors C [L,6,6], CD [L,6], m [L]."""
    md2 = float(np.float32(max_dist2))
    links = np.asarray(links, np.int64).reshape(-1, 2)
    N = points_g.shape[1]
    dev = points_g.device
    outs = []
    for c0 in range(0, len(links), LINK_CHUNK):
        chunk = links[c0 : c0 + LINK_CHUNK]
        idx = torch.empty((len(chunk), N), dtype=torch.int64, device=dev)
        found = torch.empty((len(chunk), N), dtype=torch.bool, device=dev)
        for k, (i, j) in enumerate(chunk.tolist()):
            idx[k], _d2, found[k] = nn_ops.nn_brute_auto(
                points_g[j], masks[j], points_g[i], masks[i], md2
            )
        a, b = gather_pairs(points_g, torch.as_tensor(chunk, device=dev), idx)
        outs.append(lum_pair_stats(a, b, found))
    if not outs:
        z = torch.zeros((0, 6, 6), dtype=torch.float32, device=dev)
        return z, z[:, 0], z[:, 0, 0]
    return tuple(torch.cat([o[k] for o in outs]) for k in range(3))


def link_covariances_global(locals_pts, masks, mats, links, max_dist2):
    """:func:`link_covariances` fed from RESIDENT local-frame tensors:
    the global transform runs on the device from the pose stack, so
    callers that relax repeatedly over growing prefixes (GraphPipeline,
    ELCH) upload only the [S,4,4] poses per call."""
    return link_covariances(
        global_points(locals_pts, mats), masks, links, max_dist2
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
    [L,6], m [L], guard_fired: bool) — when a point of a link's model or
    target lies outside the grid box the caller should retry with a
    larger-headroom spec.
    """
    from ..ops import nn_cell_list as ncl

    if len(links) == 0:  # a rank's empty share of the links
        z = np.zeros((0, 6, 6), np.float32)
        return z, z[:, 0], z[:, 0, 0], False

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
                dims=spec["dims"], perm=perm,
            )
        clm, oob_m = models[i]
        idx, _d2, found, oob_q = ncl.nn_cell_list_chained(
            points_g[j], masks[j], clm, md2,
            dims=spec["dims"], chunk=spec["chunk"], perm=perm,
        )
        metrics.count(CHAINED_LINK_CALLS)
        C, CD, m = lum_pair_stats(points_g[i][idx], points_g[j], found)
        packed.append(torch.cat([C.reshape(36), CD, m[None]]))
        guards.append(oob_q + oob_m)
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
    # scans padded to this many points or more route their covariances
    # through the cell-list chain (link_covariances_chained) on the host
    # path: O(occupancy) per query instead of the brute O(M) per query
    chained_min: int = 98304
    # host-path solver split: dense f64 up to this many scans,
    # block-Jacobi CG (pgsolve.solve_block_cg, O(L) memory) above; the
    # on-device path solves densely while the system fits in half the
    # device's free memory (lum_device._dense_fits)
    dense_solver_max_scans: int = 65
    # pre-uploaded (locals [S,N,3] f32, masks [S,N] bool) device tensors:
    # callers that relax repeatedly over growing prefixes (GraphPipeline)
    # upload the sequence once; scans beyond len(scans) are masked out
    device_points: tuple | None = None
    # persistent NN-correspondence cache (lum_device.CorrCache) for the
    # per-closure 1-iteration relax of continuous-closure runs: link
    # pairings are reused while the endpoints' relative pose stays
    # within tolerance; covariance stats stay exact at current poses
    corr_cache: object | None = None
    device: torch.device | str | None = None  # None: the package default
    # torch.distributed process group over which the links are split (the
    # JAX package's mesh; parallel.lum_shard): None runs unsplit
    group: object | None = None


def _resolve_device(device) -> torch.device:
    if device is None:
        from .. import default_device

        return default_device()
    return torch.device(device)


def _solve_GX_B(
    scans_n: int, links: np.ndarray, C: np.ndarray, CD: np.ndarray,
    dense_max: int,
) -> np.ndarray:
    """Solve the LUM system in f64 on the host: dense up to
    ``dense_max`` scans, block-CG (``pgsolve.solve_block_cg`` on CPU
    tensors) above."""
    if scans_n <= dense_max:
        G, B = assemble_GB(links, C, CD, scans_n)
        try:
            return np.linalg.solve(G, B).reshape(-1, 6)
        except np.linalg.LinAlgError:
            return np.linalg.lstsq(G, B, rcond=None)[0].reshape(-1, 6)
    from . import pgsolve

    n = scans_n - 1
    C = torch.as_tensor(np.asarray(C, np.float64))
    B = pgsolve.link_rhs(links, torch.as_tensor(np.asarray(CD, np.float64)), n)
    return pgsolve.solve_block_cg(links, C, B, n)[0].numpy()


def _pad_scan_points(scans, cap):
    locals_pad = np.zeros((len(scans), cap, 3), np.float32)
    masks = np.zeros((len(scans), cap), bool)
    for si, s in enumerate(scans):
        r = s.reduced_local()
        locals_pad[si, : len(r)] = r
        masks[si, : len(r)] = True
    return locals_pad, masks


@metrics.time(LUM_RELAX)
def do_graph_slam(
    scans: list[Scan], links: np.ndarray, params: LumParams
) -> float:
    """Run LUM iterations until mean pose shift < epsilon
    (doGraphSlam6D, lum6Deuler.cc:314-477).  Mutates scan poses; writes
    LUM-tagged frames (one per iteration, scan.cc:918-1009).  Returns
    final mean position shift.

    Dispatch: scans of fewer than ``chained_min`` points each relax with
    their poses on the device (``models.lum_device``; graphs whose dense
    system does not fit on the device solve by the device block-CG);
    city-scale scans take the host loop with chained covariances."""
    if len(scans) < 2 or len(links) == 0:
        return 0.0
    if params.device_points is not None:
        cap_probe = params.device_points[0].shape[1]
    else:
        cap_probe = max(len(s.reduced_local()) for s in scans)
    if cap_probe >= params.chained_min:
        return _do_graph_slam_host(scans, links, params)
    return _do_graph_slam_device(scans, links, params)


def _record_lum_iteration(scans, pos, theta) -> None:
    """One LUM-tagged frame per scan for an executed iteration
    (lum6Deuler.cc appends via Scan::transform per iteration); pos,
    theta: [>= len(scans), 3] f64 host arrays."""
    for si, s in enumerate(scans):
        if si == 0:
            s.add_frame(AlgoType.LUM)
            continue
        T = np.asarray(math3d.euler_to_matrix4(pos[si], theta[si], xp=np))
        s.set_pose(T, AlgoType.LUM, record=True)


def _do_graph_slam_device(
    scans: list[Scan], links: np.ndarray, params: LumParams
) -> float:
    """The relaxation with points and poses resident on the device: per
    iteration one brute NN call (kernel K1) per link, the dense solve
    and the pose update there, and one host read (the convergence
    scalar with the new poses, for the frames)."""
    from . import lum_device

    n_real = len(scans)
    if params.device_points is not None:
        locals_t, masks_t = params.device_points
    else:
        dev = _resolve_device(params.device)
        cap = _round_up(max(len(s.reduced_local()) for s in scans), _PAD)
        locals_pad, masks = _pad_scan_points(scans, cap)
        locals_t = torch.as_tensor(locals_pad, device=dev)
        masks_t = torch.as_tensor(masks, device=dev)
    S = int(locals_t.shape[0])
    if n_real > S:
        raise ValueError(f"{n_real} scans but device_points holds {S}")

    pos0 = np.zeros((S, 3))
    theta0 = np.zeros((S, 3))
    for si, s in enumerate(scans):
        theta, p = math3d.matrix4_to_euler(s.transMat)
        pos0[si] = p
        theta0[si] = theta
    links = np.asarray(links, np.int64).reshape(-1, 2)

    cache = params.corr_cache
    if (
        cache is not None
        and int(params.iterations) == 1
        and cache.N == int(locals_t.shape[1])
        and _world(params.group) == 1
    ):
        # cached path for the PER-CLOSURE 1-iteration relax only.  The
        # JAX package measured (h468) that extending it to the
        # multi-iteration final relax degraded ATE 18.3 -> 28.4 cm:
        # within-relax pairing reuse interferes with LUM convergence,
        # across-closure reuse does not.  A group of several ranks
        # relaxes uncached (every link's NN, split over the ranks): the
        # cache's slots would move between ranks whenever it grows, and
        # a rank would read pairings it never refreshed.
        mats_np = np.asarray(math3d.euler_to_matrix4(pos0, theta0, xp=np))
        prepared = cache.prepare(links, mats_np)
        pos, theta, ret = lum_device.lum_step_cached(
            locals_t, masks_t, *prepared[:2], pos0, theta0, n_real,
            params.max_dist_match2, cache, *prepared[2:],
        )
        _record_lum_iteration(scans, pos, theta)
        return ret

    _pos, _theta, _n_it, ret = lum_device.lum_run(
        locals_t, masks_t, links, np.ones(len(links), bool), pos0, theta0,
        n_real, params.max_dist_match2, params.epsilon,
        iterations=int(params.iterations),
        on_iteration=lambda pos, theta: _record_lum_iteration(scans, pos, theta),
        group=params.group,
    )
    return ret


def _world(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def _link_spec(clouds, links, max_dist, headroom, device):
    from ..ops import nn_cell_list as ncl

    return ncl.cell_list_spec(
        clouds, max_dist, headroom=headroom,
        model_sets=clouds, queries=clouds,
        pairs=[(int(i), int(j)) for i, j in np.asarray(links)],
        device=device,
    )


def _do_graph_slam_host(
    scans: list[Scan], links: np.ndarray, params: LumParams
) -> float:
    """Host-orchestrated LUM: per iteration the link covariances on the
    device and the f64 solve and pose update on the host.  With
    ``params.group`` each rank computes the covariances of its contiguous
    share of the links, on the same engine, and ``parallel.mesh.sum_rows``
    sums them over the ranks (the JAX package's mesh route)."""
    from ..parallel.mesh import group_range, sum_rows

    dev = _resolve_device(params.device)
    cap = _round_up(max(len(s.reduced_local()) for s in scans), _PAD)
    locals_pad, masks = _pad_scan_points(scans, cap)
    locals_t = torch.as_tensor(locals_pad, device=dev)
    masks_t = torch.as_tensor(masks, device=dev)
    max_dist = float(np.sqrt(params.max_dist_match2))
    lo, hi = group_range(len(links), params.group)
    share = np.asarray(links, np.int64).reshape(-1, 2)[lo:hi]

    chain_spec = None
    if cap >= params.chained_min:
        clouds = [
            np.asarray(
                math3d.transform3(s.transMat, s.reduced_local()), np.float32
            )
            for s in scans
        ]
        chain_spec = _link_spec(clouds, links, max_dist, 2.0, dev)

    ret = np.inf
    it = 0
    while it < params.iterations and ret > params.epsilon:
        mats = torch.as_tensor(
            np.stack([s.transMat for s in scans]).astype(np.float32), device=dev
        )
        points_g = global_points(locals_t, mats)
        with metrics.time(LUM_COV):
            if chain_spec is not None:
                C, CD, _m, guard = link_covariances_chained(
                    points_g, masks_t, share, params.max_dist_match2,
                    chain_spec,
                )
                if guard:
                    # box exit: re-spec from the CURRENT global clouds
                    # with double headroom
                    clouds = [
                        points_g[i][masks_t[i]] for i in range(len(scans))
                    ]
                    chain_spec = _link_spec(clouds, links, max_dist, 4.0, dev)
                    if chain_spec is not None:
                        C, CD, _m, guard = link_covariances_chained(
                            points_g, masks_t, share,
                            params.max_dist_match2, chain_spec,
                        )
            if chain_spec is None:
                C, CD, _m = link_covariances(
                    points_g, masks_t, share, params.max_dist_match2
                )
                metrics.count(LUM_LINK_CALLS, len(share))
                C, CD = C.cpu().numpy(), CD.cpu().numpy()
            C, CD = sum_rows(params.group, len(links), np.arange(lo, hi), C, CD)
        with metrics.time(LUM_SOLVE):
            X = _solve_GX_B(len(scans), links, C, CD, params.dense_solver_max_scans)
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
