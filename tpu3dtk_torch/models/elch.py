"""ELCH — Explicit Loop Closing Heuristic, the port of
``tpu3dtk/models/elch.py``: the slerp variant ``elch6Dslerp``
(src/slam6d/elch6Dslerp.cc:44-200, the -L 4 default) with the
Dijkstra-based error-distribution weights of ``elch6D::graph_balancer``
(src/slam6d/elch6D.cc:186-280).  The variants -L 1..3 (euler, quat,
unitQuat) are not ported: ``ELCH_VARIANTS`` holds 4 only.

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

__all__ = ["ELCH_VARIANTS", "ElchParams", "close_loop", "graph_balancer"]

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
    with metrics.time(ELCH_COV):
        C = _edge_covariances_euler(scans, graph_edges, params)
    with metrics.time(ELCH_BALANCE):
        wd = _inv_diag_weights(C, 6)
        wtrans = wd[:, :3]
        wrot = wd[:, 3:].sum(axis=1)
        weights = [
            graph_balancer(graph_edges, wtrans[:, k], first, last, n)
            for k in range(3)
        ] + [graph_balancer(graph_edges, wrot, first, last, n)]

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



# -L 4 (ref slam6D.cc:696-727 loopSlam6DAlgo switch); -L 1..3 need the
# quaternion link covariances of graphslam_variants, which are not ported
ELCH_VARIANTS = {4: close_loop}
