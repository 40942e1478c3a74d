"""ELCH — Explicit Loop Closing Heuristic, the port of
``tpu3dtk/models/elch.py``: the slerp variant ``elch6Dslerp``
(src/slam6d/elch6Dslerp.cc:44-200, the -L 4 default) with the
Dijkstra-based error-distribution weights of ``elch6D::graph_balancer``
(src/slam6d/elch6D.cc:186-280), and the variants -L 1 euler
(:func:`close_loop_euler`), -L 2 quat (:func:`close_loop_quat`) and
-L 3 unitQuat (:func:`close_loop_unitquat`), all four in
``ELCH_VARIANTS``.  The quaternion variants weigh the edges by the 7x7
quaternion LUM covariances, from the raw sums of
``graphslam_variants.link_raw_sums`` (no correspondence cache, as in the
JAX package).

Pipeline on loop detection (first, last):
1. per-edge weights from pose-graph covariances: 4 weight graphs (x, y,
   z translation variances + summed rotation variance) from the inverse
   link covariance diagonals (ref elch6Dslerp.cc:57-83; the reference
   uses the quaternion 7x7 covariance — this uses the euler 6x6 of the
   LUM link statistics, an equivalent uncertainty scale).
2. graph_balancer: distribute weight 0 at `first` → 1 at `last` along
   shortest paths; branches inherit their junction's weight.
3. ICP-match a metascan around `first` against one around `last`
   (window sizes first±2, last-2..last, ref elch6Dslerp.cc:93-110).
4. slerp-interpolate the resulting correction over every scan by its
   weight (elch6Dslerp.cc:150-180).

The graph algorithms run on the host (tiny, f64 numpy and scipy);
covariances and the ICP match run on the device, every NN call through
the brute engine (kernel K1 on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import math3d
from ..core.scan import Scan
from ..io.frames import AlgoType
from ..utils.metrics import metrics
from . import graphslam as gs

__all__ = [
    "ELCH_VARIANTS", "ElchParams", "close_loop", "close_loop_euler", "close_loop_quat",
    "close_loop_unitquat", "graph_balancer",
]

# metrics timers of a closure, and the counter of its loop-ICP
# iterations (one brute NN call each)
ELCH_COV = "elch_cov_time"
ELCH_BALANCE = "elch_balance_time"
ELCH_ICP = "elch_icp_time"
ELCH_ICP_ITERATIONS = "elch_icp_iterations"


def _all_dijkstra_py(adj, sources, n):
    """heapq Dijkstra rows matching scipy's (D, P) contract:
    P = -9999 for source/unreachable."""
    import heapq

    D = np.full((len(sources), n), np.inf)
    P = np.full((len(sources), n), -9999, np.int64)
    for si, src in enumerate(sources):
        dist = {src: 0.0}
        pq = [(0.0, src)]
        while pq:
            d, u = heapq.heappop(pq)
            if d > dist.get(u, np.inf):
                continue
            for v, w in adj[u].items():
                nd = d + w
                if nd < dist.get(v, np.inf):
                    dist[v] = nd
                    P[si, v] = u
                    heapq.heappush(pq, (nd, v))
        for v, d in dist.items():
            D[si, v] = d
    return D, P


def graph_balancer(edges, weights_per_edge, first, last, n):
    """Distribute loop-closing weights over the pose graph.

    Faithful reimplementation of elch6D::graph_balancer
    (elch6D.cc:186-280): weights[first]=0, weights[last]=1;
    repeatedly find the shortest crossing path between junction
    vertices, linearly interpolate weights along it by path distance,
    remove its edges; finally propagate weights into branches.

    edges: [(u, v)], weights_per_edge: [w] (same length), n vertices.
    Returns weights [n].
    """
    adj: dict[int, dict[int, float]] = {i: {} for i in range(n)}
    for (u, v), w in zip(edges, weights_per_edge):
        adj[u][v] = min(w, adj[u].get(v, np.inf))
        adj[v][u] = min(w, adj[v].get(u, np.inf))

    weights = np.zeros(n)
    weights[first] = 0.0
    weights[last] = 1.0
    crossings = [first, last]
    branches: list[int] = []

    # one C-compiled multi-source Dijkstra per outer iteration (scipy
    # csgraph) instead of one Python heapq Dijkstra per crossing —
    # identical semantics (predecessor == -9999 <=> the original's
    # `prev[e] == e` self/unreachable test), ~30x less host time in the
    # continuous-closure regime where the balancer runs 4x per closure
    def _all_dijkstra(sources):
        try:
            from scipy.sparse import csr_array
            from scipy.sparse.csgraph import dijkstra as cs_dijkstra
        except ImportError:  # pure-Python fallback (scipy optional)
            return _all_dijkstra_py(adj, sources, n)

        rows, cols, vals = [], [], []
        for u, nbrs in adj.items():
            for v, w in nbrs.items():
                rows.append(u)
                cols.append(v)
                vals.append(w)
        g = csr_array(
            (np.asarray(vals, float), (rows, cols)), shape=(n, n)
        )
        D, P = cs_dijkstra(
            g, directed=False, indices=sources, return_predecessors=True
        )
        return np.atleast_2d(D), np.atleast_2d(P)

    while crossings:
        best = None  # (dist, si, e)
        drop = []
        D, P = _all_dijkstra(crossings)
        cross_arr = np.asarray(crossings)
        for si, s in enumerate(crossings):
            later = cross_arr[si + 1 :]
            reach = P[si, later] >= 0  # == original `prev[e] != e` test
            if reach.any():
                dd = np.where(reach, D[si, later], np.inf)
                k = int(np.argmin(dd))
                if best is None or dd[k] < best[0]:
                    best = (float(dd[k]), si, int(later[k]))
            elif best is None:
                drop.append(s)
        if best is not None:
            _, bsi, e = best
            s = crossings[bsi]
            dist = D[bsi]
            prev = P[bsi].copy()
            prev[s] = s
            best = (best[0], s, e, prev, dist)
        for s in drop:
            branches.append(s)
            crossings.remove(s)
        if best is None:
            continue
        _, s, e, prev, dist = best
        # interpolate along path e -> s, removing edges
        def remove_edge(u, v):
            adj[u].pop(v, None)
            adj[v].pop(u, None)

        remove_edge(e, prev[e])
        i = prev[e]
        while i != s:
            weights[i] = weights[s] + (weights[e] - weights[s]) * dist[i] / dist[e]
            remove_edge(i, prev[i])
            if len(adj[i]) > 0:
                crossings.append(i)
            i = prev[i]
        if len(adj[s]) == 0 and s in crossings:
            crossings.remove(s)
        if len(adj[e]) == 0 and e in crossings:
            crossings.remove(e)

    # propagate into branches (elch6D.cc:266-280)
    while branches:
        s = branches.pop(0)
        for v in list(adj[s].keys()):
            weights[v] = weights[s]
            if len(adj[v]) > 1:
                branches.append(v)
        for v in list(adj[s].keys()):
            adj[v].pop(s, None)
        adj[s].clear()
    return weights


def _slerp(q0, q1, t):
    """Quaternion slerp (ref globals.icc slerp)."""
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -np.asarray(q1)
        d = -d
    d = min(1.0, max(-1.0, d))
    th = np.arccos(d)
    if th < 1e-8:
        out = (1 - t) * np.asarray(q0) + t * np.asarray(q1)
    else:
        out = (
            np.sin((1 - t) * th) * np.asarray(q0) + np.sin(t * th) * np.asarray(q1)
        ) / np.sin(th)
    return out / np.linalg.norm(out)


def _quat_mult(a, b):
    """Hamilton product a*b, [w,x,y,z] (ref globals.icc QMult)."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _nlerp(q0, q1, t):
    """Normalized linear interpolation (the reference's additive
    quaternion blending in elch6DunitQuat.cc:160-180 + Normalize4)."""
    out = (1.0 - t) * np.asarray(q0) + t * np.asarray(q1)
    return out / np.linalg.norm(out)


@dataclasses.dataclass
class ElchParams:
    max_dist_match2: float = 625.0
    icp_iterations: int = 100
    icp_epsilon: float = 1e-7
    # GraphPipeline pins the whole sequence as resident (locals
    # [S, cap, 3], masks [S, cap]) device tensors shared with the
    # sequential matches and LUM; without them every closure pads and
    # uploads its scans anew
    device_points: tuple | None = None
    # persistent NN-correspondence cache (lum_device.CorrCache): edge
    # pairings are reused across closures while the endpoints' relative
    # pose stays within tolerance (the reference recomputes every edge
    # every closure, elch6Dslerp.cc:56-85 — pure waste in the
    # continuous-closure regime where adjacent poses barely move)
    corr_cache: object | None = None
    device: torch.device | str | None = None  # None: the package default


def _pose_stack(scans, S: int, dtype):
    """[S,4,4] current poses, identity beyond the given scans."""
    mats = np.tile(np.eye(4, dtype=dtype), (S, 1, 1))
    for si, s in enumerate(scans):
        mats[si] = s.transMat
    return mats


def _edge_covariances_euler(scans, graph_edges, params):
    """Per-edge 6x6 LUM-Euler covariances in the current global frames
    (the covarianceEuler role, elch6Deuler.cc:50-64), f64 numpy [E,6,6].

    With ``device_points`` the global transform runs on the device from
    the pose stack, padded with identity to the resident S scans; with a
    correspondence cache on top, only stale edges pay an NN call."""
    if params.device_points is not None:
        locals_t, masks_t = params.device_points
        S = int(locals_t.shape[0])
        mats = torch.as_tensor(
            _pose_stack(scans, S, np.float32), device=locals_t.device
        )
        cache = params.corr_cache
        if cache is not None and cache.N == int(locals_t.shape[1]):
            from .lum_device import link_cov_cached

            edges_arr = np.asarray(graph_edges, np.int64).reshape(-1, 2)
            prepared = cache.prepare(edges_arr, _pose_stack(scans, S, np.float64))
            C, _CD, _m = link_cov_cached(
                locals_t, masks_t, mats, *prepared[:2], cache, *prepared[2:],
                params.max_dist_match2,
            )
            slot = [cache.slots[tuple(e)] for e in edges_arr.tolist()]
            return C.cpu().numpy().astype(np.float64)[slot]
        C, _CD, _m = gs.link_covariances_global(
            locals_t, masks_t, mats, graph_edges, params.max_dist_match2
        )
        return C.cpu().numpy().astype(np.float64)

    dev = gs._resolve_device(params.device)
    n = len(scans)
    cap = gs._round_up(max(len(s.reduced_local()) for s in scans), gs._PAD)
    pts = np.zeros((n, cap, 3), np.float32)
    msk = np.zeros((n, cap), bool)
    for si, s in enumerate(scans):
        r = s.reduced_local()
        pts[si, : len(r)] = np.asarray(math3d.transform3(s.transMat, r))
        msk[si, : len(r)] = True
    C, _CD, _m = gs.link_covariances(
        torch.as_tensor(pts, device=dev), torch.as_tensor(msk, device=dev),
        graph_edges, params.max_dist_match2,
    )
    return C.cpu().numpy().astype(np.float64)


def _edge_covariances_quat(scans, graph_edges, params):
    """Per-edge 7x7 LUM-Quat covariances (the covarianceQuat role,
    elch6Dquat.cc:50-64) from the raw sums, f64 numpy [E,7,7]; on the
    resident upload where ``device_points`` is given."""
    from .graphslam_variants import _collect_raw, _quat_link_CCD

    lp = gs.LumParams(
        max_dist_match2=params.max_dist_match2,
        device_points=params.device_points,
        device=params.device,
    )
    C, _CD = _quat_link_CCD(_collect_raw(scans, np.asarray(graph_edges, np.int64), lp))
    return C.cpu().numpy()


def _inv_diag_weights(C, n_dof):
    """Edge weights = |diag(C⁻¹)| per dof (elch6D*.cc:56-64)."""
    E = len(C)
    w = np.zeros((E, n_dof))
    for li in range(E):
        try:
            Cinv = np.linalg.inv(C[li])
        except np.linalg.LinAlgError:
            Cinv = np.eye(n_dof)
        w[li] = np.abs(np.diag(Cinv))[:n_dof]
    return w


def _orthonormal_align(res) -> np.ndarray:
    metrics.count(ELCH_ICP_ITERATIONS, res.iterations)
    align = res.T.cpu().numpy().astype(np.float64)
    u, _, vt = np.linalg.svd(align[:3, :3])
    align[:3, :3] = u @ vt
    return align


def _loop_icp_align(scans, first, last, params):
    """ICP of metascan(first±2) vs metascan(last-2..last) in global
    frames.  Returns the orthonormalized 4x4 ``align`` with
    P_new = align @ P_old for the end-window scans
    (elch6D*.cc my_icp6D->match(start, end))."""
    from . import icp as icp_mod

    n = len(scans)

    if params.device_points is not None:
        locals_t, masks_t = params.device_points
        mats = torch.as_tensor(
            _pose_stack(scans, int(locals_t.shape[0]), np.float32),
            device=locals_t.device,
        )
        return _orthonormal_align(icp_mod.icp_window_align(
            locals_t, masks_t, mats, first, last, n,
            params.max_dist_match2, params.icp_epsilon,
            max_iterations=params.icp_iterations,
        ))

    dev = gs._resolve_device(params.device)

    def window_global(lo, hi):
        """Scans [lo, hi] in the global frame, padded to a multiple of
        512 points, on the device with their mask."""
        pts = np.concatenate([
            np.asarray(math3d.transform3(scans[i].transMat, scans[i].reduced_local()))
            for i in range(max(0, lo), min(n, hi + 1))
        ]).astype(np.float32)
        cap = gs._round_up(len(pts), gs._PAD)
        padded = np.zeros((cap, 3), np.float32)
        padded[: len(pts)] = pts
        return (
            torch.as_tensor(padded, device=dev),
            torch.as_tensor(np.arange(cap) < len(pts), device=dev),
        )

    model, mmask = window_global(first - 2, first + 2)
    target, tmask = window_global(last - 2, last)
    return _orthonormal_align(icp_mod.icp_pair(
        model, mmask, target, tmask,
        torch.eye(4, dtype=torch.float32, device=dev),
        max_dist_match2=params.max_dist_match2,
        epsilon=params.icp_epsilon,
        max_iterations=params.icp_iterations,
    ))


def close_loop(
    scans: list[Scan],
    first: int,
    last: int,
    graph_edges: list[tuple[int, int]],
    params: ElchParams,
) -> None:
    """Close the loop (first, last): ICP metascan(first±2) vs
    metascan(last-2..last), distribute the correction by balanced
    weights with per-axis translation scaling + rotation slerp
    (elch6Dslerp.cc:93-190).  Mutates scan poses (ELCH frames)."""
    n = len(scans)

    # 1-2. edge weights from link covariances -> balanced vertex weights
    weights = _balanced_weights(
        scans, first, last, graph_edges, params, _edge_covariances_euler,
        [[0], [1], [2], [3, 4, 5]],
    )

    # 3. ICP: metascan around first vs metascan around last
    end_lo, end_hi = last - 2, last
    Pl0 = scans[last].transMat.copy()
    Pf0 = scans[first].transMat.copy()
    with metrics.time(ELCH_ICP):
        align = _loop_icp_align(scans, first, last, params)
    Pp0 = align @ Pl0

    # delta (elch6Dslerp.cc:121-131):
    # deltaf = Pf0^-1 · Pp0 · (Pf0^-1 · Pl0)^-1
    Pf0_inv = np.asarray(math3d.m4inv(Pf0))
    tmp1 = Pf0_inv @ Pl0
    deltaf = Pf0_inv @ Pp0 @ np.asarray(math3d.m4inv(tmp1))
    deltaQ = np.asarray(math3d.matrix4_to_quat(deltaf))
    deltaT = deltaf[:3, 3]

    idQ = np.array([1.0, 0, 0, 0])
    # delta0 = Pf0 · (w0-fraction of delta)^-1  (elch6Dslerp.cc:152-159)
    rPos0 = deltaT * np.array([weights[0][0], weights[1][0], weights[2][0]])
    q0 = _slerp(idQ, deltaQ, weights[3][0])
    tmp1 = np.asarray(math3d.quat_to_matrix4(q0, rPos0))
    delta0 = Pf0 @ np.asarray(math3d.m4inv(tmp1))

    # 4. distribute (elch6Dslerp.cc:163-180).  The reference's ICP match
    # already applied `align` to the end-window scans before the loop
    # multiplies delta0·Pf0⁻¹ on top; we fold it in here instead.
    for i in range(1, n):
        if end_lo <= i <= end_hi:
            Ti = delta0 @ Pf0_inv @ align
        else:
            rPos = deltaT * np.array(
                [weights[0][i], weights[1][i], weights[2][i]]
            )
            qi = _slerp(idQ, deltaQ, weights[3][i])
            frac = np.asarray(math3d.quat_to_matrix4(qi, rPos))
            Ti = delta0 @ frac @ Pf0_inv
        scans[i].transform(Ti, AlgoType.ELCH, record=True)
    scans[0].add_frame(AlgoType.ELCH)


def _balanced_weights(scans, first, last, graph_edges, params, cov_fn, groups):
    """Edge covariances (``cov_fn``), |diag C⁻¹| per dof, summed over each
    dof group of ``groups``, and one graph_balancer round per group:
    weights [len(groups), n] (elch6D*.cc:56-83)."""
    with metrics.time(ELCH_COV):
        C = cov_fn(scans, graph_edges, params)
    with metrics.time(ELCH_BALANCE):
        wd = _inv_diag_weights(C, C.shape[-1])
        return np.stack([
            graph_balancer(graph_edges, wd[:, g].sum(axis=1), first, last, len(scans))
            for g in groups
        ])


def _match_end_window(scans, first, last, params):
    """The loop ICP, and its alignment applied to the end-window scans
    last-2..last without a frame (the my_icp6D->match side effect of the
    euler and quat variants).  Returns the alignment."""
    with metrics.time(ELCH_ICP):
        align = _loop_icp_align(scans, first, last, params)
    for i in range(max(0, last - 2), last + 1):
        scans[i].set_pose(align @ scans[i].transMat, AlgoType.INVALID, record=False)
    return align


def close_loop_euler(
    scans: list[Scan],
    first: int,
    last: int,
    graph_edges: list[tuple[int, int]],
    params: ElchParams,
) -> None:
    """elch6Deuler::close_loop (-L 1, ref elch6Deuler.cc:42-139): six
    weight graphs (|diag C⁻¹| per Euler dof), the loop-closing delta is
    the change of scan `last`'s Euler pose under the loop ICP, and every
    scan's pose moves additively by delta·(w_dof[i] − w_dof[0]).  The
    end-window scans keep their matched poses (zero weights)."""
    n = len(scans)
    weights = _balanced_weights(
        scans, first, last, graph_edges, params, _edge_covariances_euler,
        [[k] for k in range(6)],
    )
    weights[:, last - 2 : last + 1] = 0.0  # elch6Deuler.cc:85-89
    Pl0 = scans[last].transMat.copy()
    th0, pos0 = math3d.matrix4_to_euler(Pl0, xp=np)
    align = _match_end_window(scans, first, last, params)
    th1, pos1 = math3d.matrix4_to_euler(align @ Pl0, xp=np)
    delta = np.concatenate([np.asarray(pos1) - pos0, np.asarray(th1) - th0])
    for i in range(1, n):
        th, pos = math3d.matrix4_to_euler(scans[i].transMat, xp=np)
        new_pos = np.asarray(pos) + delta[:3] * (weights[:3, i] - weights[:3, 0])
        new_th = np.asarray(th) + delta[3:] * (weights[3:, i] - weights[3:, 0])
        T = np.asarray(math3d.euler_to_matrix4(new_pos, new_th, xp=np))
        scans[i].set_pose(T, AlgoType.ELCH)
    scans[0].add_frame(AlgoType.ELCH)


def close_loop_quat(
    scans: list[Scan],
    first: int,
    last: int,
    graph_edges: list[tuple[int, int]],
    params: ElchParams,
) -> None:
    """elch6Dquat::close_loop (-L 2, ref elch6Dquat.cc:44-151): seven
    weight graphs from the 7x7 quaternion covariance; delta is the
    componentwise (pos, quat) change of scan `last`; each scan's quat
    moves additively and is renormalized.  The end-window scans keep
    their matched poses (zero weights)."""
    n = len(scans)
    weights = _balanced_weights(
        scans, first, last, graph_edges, params, _edge_covariances_quat,
        [[k] for k in range(7)],
    )
    weights[:, last - 2 : last + 1] = 0.0
    Pl0 = scans[last].transMat.copy()
    q0 = np.asarray(math3d.matrix4_to_quat(Pl0))
    align = _match_end_window(scans, first, last, params)
    Pl1 = align @ Pl0
    q1 = np.asarray(math3d.matrix4_to_quat(Pl1))
    if np.dot(q0, q1) < 0:  # consistent hemisphere for the difference
        q1 = -q1
    delta = np.concatenate([Pl1[:3, 3] - Pl0[:3, 3], q1 - q0])
    for i in range(1, n):
        Ti = scans[i].transMat
        qi = np.asarray(math3d.matrix4_to_quat(Ti))
        new_pos = Ti[:3, 3] + delta[:3] * (weights[:3, i] - weights[:3, 0])
        new_q = qi + delta[3:] * (weights[3:, i] - weights[3:, 0])
        T = np.asarray(math3d.quat_to_matrix4(new_q / np.linalg.norm(new_q), new_pos))
        scans[i].set_pose(T, AlgoType.ELCH)
    scans[0].add_frame(AlgoType.ELCH)


def close_loop_unitquat(
    scans: list[Scan],
    first: int,
    last: int,
    graph_edges: list[tuple[int, int]],
    params: ElchParams,
) -> None:
    """elch6DunitQuat::close_loop (-L 3, ref elch6DunitQuat.cc:44-200):
    four weight graphs (3 translation + the summed quaternion rotation
    dofs of the 7x7 covariance); the end-window poses are RESTORED after
    the loop ICP (the reference transforms them back) and, unlike euler
    and quat, keep their weights; rotation distributed by nlerp towards
    deltaQ·q_i with a scan-0 compensation factor."""
    n = len(scans)
    weights = _balanced_weights(
        scans, first, last, graph_edges, params, _edge_covariances_quat,
        [[0], [1], [2], [3, 4, 5, 6]],
    )
    Pl0 = scans[last].transMat.copy()
    q1c = np.asarray(math3d.matrix4_to_quat(Pl0))
    q1c[1:] = -q1c[1:]  # conjugate (elch6DunitQuat.cc:118-122)
    with metrics.time(ELCH_ICP):
        align = _loop_icp_align(scans, first, last, params)
    Pl1 = align @ Pl0
    deltaT = Pl1[:3, 3] - Pl0[:3, 3]
    deltaQ = _quat_mult(np.asarray(math3d.matrix4_to_quat(Pl1)), q1c)  # q2 * q1⁻¹
    # scan-0 compensation (elch6DunitQuat.cc:168-178)
    q_s0 = np.asarray(math3d.matrix4_to_quat(scans[0].transMat))
    blend0 = _nlerp(q_s0, _quat_mult(deltaQ, q_s0), weights[3, 0])
    scan0_pdelta = _quat_mult(q_s0, blend0 * np.array([1.0, -1.0, -1.0, -1.0]))
    for i in range(1, n):
        Ti = scans[i].transMat
        qi = np.asarray(math3d.matrix4_to_quat(Ti))
        new_pos = Ti[:3, 3] + deltaT * (weights[:3, i] - weights[:3, 0])
        new_q = _quat_mult(scan0_pdelta, _nlerp(qi, _quat_mult(deltaQ, qi), weights[3, i]))
        T = np.asarray(math3d.quat_to_matrix4(new_q / np.linalg.norm(new_q), new_pos))
        scans[i].set_pose(T, AlgoType.ELCH)
    scans[0].add_frame(AlgoType.ELCH)


# -L 1..4 (ref slam6D.cc:696-727 loopSlam6DAlgo switch)
ELCH_VARIANTS = {
    1: close_loop_euler,
    2: close_loop_quat,
    3: close_loop_unitquat,
    4: close_loop,
}
