"""The plain reference of the registration steps: voxel reduction,
brute nearest neighbours, point-to-point ICP with Horn's quaternion
minimizer, one Euler LUM iteration and the slerp ELCH closure.

Plain PyTorch and NumPy.  It imports nothing of the program and takes
nothing the program made: it reduces the raw scans itself and computes
every correspondence itself.  The formulas are those of 3DTK
(icp6Dquat.cc, lum6Deuler.cc, elch6D.cc, elch6Dslerp.cc); the step
logic follows ``scripts/cpu_pipeline.py``'s f64 pipeline.

``Prec`` says how it computes: ``REFERENCE`` in float64, and
``CONTROL``, the nearest precision below the float32 (TF32 off) the
configurations state: float32 with the nearest-neighbour ranking as a
TF32 product (a tensor-core ranking is the step that would tempt a later
change).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import math3d as m3

_POSE_T = float(np.float32(1e-2))  # ICP pose-fixpoint test (cm)
_POSE_R = float(np.float32(1e-5))  # and its rotation part
_BITS = 20  # bits per axis of a voxel id


@dataclasses.dataclass(frozen=True)
class Prec:
    dtype: torch.dtype
    tf32: bool


REFERENCE = Prec(torch.float64, False)
CONTROL = Prec(torch.float32, True)


def to_tf32(x):
    """f32 values rounded to TF32's 10-bit mantissa (to nearest, ties to
    even): what a tensor-core product reads of its f32 inputs.  Rounded
    explicitly, because for a product over 3 coordinates the library
    may choose a kernel that ignores the TF32 setting."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def reduce_scan(xyz: np.ndarray, voxel: float, nrpts: int, seed: int = 0) -> np.ndarray:
    """``-r voxel -O nrpts``: the points permuted by
    ``torch.randperm(n)`` of a CPU generator seeded with ``seed``, hashed
    to voxels in f32 from the cloud's minimum corner, stably sorted by
    voxel id, and the first ``nrpts`` of each voxel kept, in voxel order.
    Returns [n, 3] f32."""
    p = np.asarray(xyz, np.float32)
    perm = torch.randperm(len(p), generator=torch.Generator().manual_seed(int(seed))).numpy()
    p = p[perm]
    origin = p.min(0)
    ij = np.floor((p - origin) / np.float32(voxel)).astype(np.int64)
    ij = np.clip(ij, 0, (1 << _BITS) - 2)
    lin = (ij[:, 0] << (2 * _BITS)) | (ij[:, 1] << _BITS) | ij[:, 2]
    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    head = np.ones(len(p), bool)
    head[1:] = lin_s[1:] != lin_s[:-1]
    first = np.flatnonzero(head)
    rank = np.arange(len(p)) - first[np.cumsum(head) - 1]
    return p[order][rank < nrpts]


def nearest(q, m, max_d2: float, tf32: bool = False):
    """Nearest neighbour of each row of q [Q,3] among m [M,3] (one dtype,
    one device), accepted where d² < max_d2: (index [Q], accepted [Q]).
    With ``tf32`` (the control) the ranking is the brute expansion |q|² + |m|²
    - 2 q·m about m's centroid, its product read in TF32; otherwise
    exact differences over a grid of cells as wide as the match radius,
    so that every accepted neighbour lies in one of the 27 cells around
    the query's."""
    if tf32:
        return _nearest_tf32(q, m, max_d2)
    return _nearest_grid(q, m, max_d2)


def _nearest_tf32(q, m, max_d2):
    c = m.mean(0)
    q, m = (q - c).to(torch.float32), (m - c).to(torch.float32)
    mm = (m * m).sum(1)
    mt = to_tf32(m)
    rows = max(1, (1 << 26) // max(1, m.shape[0]))
    idx, best = [], []
    for r0 in range(0, q.shape[0], rows):
        qq = q[r0 : r0 + rows]
        d2 = (qq * qq).sum(1)[:, None] + mm[None] - 2.0 * (to_tf32(qq) @ mt.T)
        v, i = d2.min(1)
        best.append(v)
        idx.append(i)
    return torch.cat(idx), torch.cat(best) < max_d2


def _nearest_grid(q, m, max_d2):
    cell = float(np.sqrt(max_d2))
    lo = torch.minimum(q.min(0).values, m.min(0).values) - cell
    qc = torch.floor((q - lo) / cell).long()
    mc = torch.floor((m - lo) / cell).long()
    dims = torch.maximum(qc.max(0).values, mc.max(0).values) + 2

    def key(c):
        return (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]

    order = torch.argsort(key(mc))
    mk = key(mc)[order]
    ms = m[order]
    uniq, counts = torch.unique_consecutive(mk, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    occ = int(counts.max())
    ar = torch.arange(occ, device=q.device)
    offs = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)], device=q.device)
    best = torch.empty(q.shape[0], dtype=q.dtype, device=q.device)
    bidx = torch.empty(q.shape[0], dtype=torch.int64, device=q.device)
    # the 27 cells around each query at once, in blocks of queries
    rows = max(1, (1 << (24 if q.is_cuda else 21)) // (27 * occ))
    for r0 in range(0, q.shape[0], rows):
        qq, qcc = q[r0 : r0 + rows], qc[r0 : r0 + rows]
        k = key(qcc[:, None] + offs[None])  # [r, 27]
        pos = torch.searchsorted(uniq, k).clamp(max=len(uniq) - 1)
        cnt = torch.where(uniq[pos] == k, counts[pos], 0)
        cand = (starts[pos][..., None] + ar).clamp(max=len(ms) - 1).reshape(len(qq), -1)  # [r, 27 * occ]
        d2 = ((ms[cand] - qq[:, None]) ** 2).sum(-1)
        d2 = torch.where((ar[None, None] < cnt[..., None]).reshape(len(qq), -1), d2, float("inf"))
        v, j = d2.min(1)
        best[r0 : r0 + rows] = v
        bidx[r0 : r0 + rows] = order[cand.gather(1, j[:, None])[:, 0]]
    return bidx, best < max_d2


def _tensor(x, prec, device):
    return torch.as_tensor(np.asarray(x), device=device).to(prec.dtype)


def _transform(T, pts_t):
    T = torch.as_tensor(T, dtype=pts_t.dtype, device=pts_t.device)
    return pts_t @ T[:3, :3].T + T[:3, 3]


def icp(model_g, target_local, T0, max_d2, epsilon, max_iterations, prec, device):
    """Point-to-point ICP of ``target_local`` (local frame, numpy) against
    ``model_g`` (global frame, numpy) from pose ``T0``, Horn's quaternion
    minimizer (icp6Dquat.cc), with the program's stop tests: the two
    deltas of the RMS error below ``epsilon`` (icp6D.cc:266-279), an
    increment below 1e-2 cm and 1e-5, or 3 pairs or fewer.  Returns
    (T [4,4] f64, iterations)."""
    np_dt = np.float64 if prec.dtype == torch.float64 else np.float32
    m = _tensor(model_g, prec, device)
    t_loc = _tensor(target_local, prec, device)
    T = np.asarray(T0, np.float64)
    eps = float(np.float32(epsilon))
    ret = prev = prev2 = 0.0
    it = 0
    while it < max_iterations:
        tg = _transform(T, t_loc)
        idx, ok = nearest(tg, m, max_d2, prec.tf32)
        n = int(ok.sum())
        it += 1
        if n <= 3:
            break
        mm, dd = m[idx][ok], tg[ok]
        cm, cd = mm.mean(0), dd.mean(0)
        S = ((dd - cd).T @ (mm - cm) / n).cpu().numpy().astype(np_dt)
        err = float(torch.sqrt(((mm - dd) ** 2).sum() / n))
        tr = np.trace(S)
        a = np.array([S[1, 2] - S[2, 1], S[2, 0] - S[0, 2], S[0, 1] - S[1, 0]], np_dt)
        Q = np.zeros((4, 4), np_dt)
        Q[0, 0], Q[0, 1:], Q[1:, 0] = tr, a, a
        Q[1:, 1:] = S + S.T - tr * np.eye(3, dtype=np_dt)
        _w, V = np.linalg.eigh(Q)
        R = m3.quat_to_matrix3(V[:, -1].astype(np.float64))
        align = np.eye(4)
        align[:3, :3] = R
        align[:3, 3] = cm.cpu().numpy().astype(np.float64) - R @ cd.cpu().numpy().astype(np.float64)
        T = align @ T
        prev2, prev, ret = prev, ret, err
        conv = abs(ret - prev) < eps and abs(ret - prev2) < eps
        pose_conv = np.linalg.norm(align[:3, 3]) < _POSE_T and np.linalg.norm(R - np.eye(3)) < _POSE_R
        if conv or pose_conv:
            break
    return T, it


def link_cov(pts_i, pts_j, max_d2, pairing=None, tf32=False):
    """The Euler LUM link statistics of lum6Deuler.cc:141-232 for link
    (i, j): scan j's points paired with their nearest neighbours in scan
    i (both global-frame tensors).  ``pairing``: (index, accepted) made
    earlier, kept while a pair's current d² is at most max_d2 (the
    correspondence cache of the closure relax).  Returns (C [6,6], CD
    [6]) f64."""
    if pairing is None:
        idx, ok = nearest(pts_j, pts_i, max_d2, tf32)
    else:
        idx, ok = pairing
        ok = ok & (((pts_i[idx] - pts_j) ** 2).sum(1) <= max_d2)
    a, b = pts_i[idx][ok], pts_j[ok]
    m = float(ok.sum())
    if m <= 2:
        return np.zeros((6, 6)), np.zeros(6)
    mid, d = 0.5 * (a + b), a - b
    x, y, z = mid[:, 0], mid[:, 1], mid[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    sums = torch.stack([
        dx.sum(), dy.sum(), dz.sum(), (-z * dy + y * dz).sum(), (-y * dx + x * dy).sum(), (z * dx - x * dz).sum(),
        x.sum(), y.sum(), z.sum(), (x * x + y * y).sum(), (x * x + z * z).sum(), (y * y + z * z).sum(),
        (x * y).sum(), (x * z).sum(), (y * z).sum(),
    ]).cpu().numpy().astype(np.float64)
    MZ = sums[:6]
    sx, sy, sz, xpy, xpz, ypz, xy, xz, yz = (float(v) for v in sums[6:])
    MM = np.array([
        [m, 0, 0, 0, -sy, sz],
        [0, m, 0, -sz, sx, 0],
        [0, 0, m, sy, 0, -sx],
        [0, -sz, sy, ypz, -xz, -xy],
        [-sy, sx, 0, -xz, xpy, -yz],
        [sz, 0, -sx, -xy, -yz, xpz],
    ])
    D = np.linalg.solve(MM, MZ)
    Dt = torch.as_tensor(D, dtype=a.dtype, device=a.device)
    rx = dx - (Dt[0] - y * Dt[4] + z * Dt[5])
    ry = dy - (Dt[1] - z * Dt[3] + x * Dt[4])
    rz = dz - (Dt[2] + y * Dt[3] - x * Dt[5])
    ss = float((rx * rx + ry * ry + rz * rz).sum()) / max(2 * m - 3, 1.0)
    if ss < 1e-13:
        return np.zeros((6, 6)), np.zeros(6)
    return MM / ss, MZ / ss


def _global(points_local, mats, prec, device):
    return [_transform(T, _tensor(p, prec, device)) for p, T in zip(points_local, mats)]


def _lum_solve(points_local, mats, links, max_d2, prec, device, paired_at=None):
    """The system of one Euler LUM iteration (lum6Deuler.cc:314-374) at
    the poses ``mats`` [S,4,4], scan 0 fixed: link statistics, G X = B
    (FillGB3D); returns X [S-1, 6].  ``paired_at``: for each link, the
    relative pose T_i⁻¹ T_j at which its pairing was made (the closure
    relax's correspondence cache), else None for a pairing at ``mats``."""
    pg = _global(points_local, mats, prec, device)
    stats = []
    for k, (i, j) in enumerate(links):
        pairing = None
        if paired_at is not None:
            loc = [_tensor(points_local[v], prec, device) for v in (i, j)]
            pairing = nearest(_transform(paired_at[k], loc[1]), loc[0], max_d2, prec.tf32)
        stats.append(link_cov(pg[i], pg[j], max_d2, pairing, prec.tf32))
    n = len(mats) - 1
    G = np.zeros((6 * n, 6 * n))
    B = np.zeros(6 * n)
    for (i, j), (C, CD) in zip(links, stats):
        a, b = i - 1, j - 1
        if a >= 0:
            B[6 * a : 6 * a + 6] += CD
            G[6 * a : 6 * a + 6, 6 * a : 6 * a + 6] += C
        if b >= 0:
            B[6 * b : 6 * b + 6] -= CD
            G[6 * b : 6 * b + 6, 6 * b : 6 * b + 6] += C
        if a >= 0 and b >= 0:
            G[6 * a : 6 * a + 6, 6 * b : 6 * b + 6] -= C
            G[6 * b : 6 * b + 6, 6 * a : 6 * a + 6] -= C
    if prec.dtype == torch.float32:
        X = np.linalg.solve(G.astype(np.float32), B.astype(np.float32)).astype(np.float64)
    else:
        X = np.linalg.solve(G, B)
    return X.reshape(n, 6)


def _ha_corrections(pos, theta, X):
    """Ha⁻¹ X of each scan (lum6Deuler.cc:375-455): [n, 6]."""
    out = np.empty_like(X)
    for k in range(len(X)):
        xa, ya, za = pos[k]
        tx, ty = theta[k, 0], theta[k, 1]
        ctx, stx, cty, sty = np.cos(tx), np.sin(tx), np.cos(ty), np.sin(ty)
        Ha = np.eye(6)
        Ha[0, 4], Ha[0, 5] = -za * ctx + ya * stx, ya * cty * ctx + za * stx * cty
        Ha[1, 3], Ha[1, 4], Ha[1, 5] = za, -xa * stx, -xa * ctx * cty + za * sty
        Ha[2, 3], Ha[2, 4], Ha[2, 5] = -ya, xa * ctx, -xa * cty * stx - ya * sty
        Ha[3, 5], Ha[4, 4], Ha[4, 5] = sty, stx, ctx * cty
        Ha[5, 4], Ha[5, 5] = ctx, -stx * cty
        out[k] = np.linalg.solve(Ha, X[k])
    return out


def lum_iteration(points_local, mats, links, max_d2, prec, device, paired_at=None):
    """One Euler LUM iteration (lum6Deuler.cc:314-477) with scan 0 fixed:
    the system at ``mats``, the pose corrections Ha⁻¹ X subtracted from
    Matrix4ToEuler of each pose; returns the new poses [S,4,4] f64."""
    X = _lum_solve(points_local, mats, links, max_d2, prec, device, paired_at)
    theta, pos = m3.matrix4_to_euler(np.asarray(mats[1:]))
    corr = _ha_corrections(pos, theta, X)
    return np.concatenate([np.asarray(mats[:1], np.float64),
                           m3.euler_to_matrix4(pos - corr[:, :3], theta - corr[:, 3:])])


def lum_relax(points_local, mats, links, max_d2, iterations, epsilon, prec, device, carry_euler,
              paired_at=None, at_least=0):
    """A LUM relaxation (doGraphSlam6D, lum6Deuler.cc:314-477) from the
    poses ``mats`` [S,4,4]: iterations until one moves the scans' positions
    by at most ``epsilon`` cm on average (scan 0 counted, never moved) or
    ``iterations`` have run, and never fewer than ``at_least``.

    With ``carry_euler`` the relax holds Matrix4ToEuler of the starting
    poses and carries that Euler state from iteration to iteration, its
    poses the state's matrices (as a relax with its poses resident on the
    device does; at a quarter turn, the gimbal branch, they differ from
    the poses it started from); otherwise every iteration starts from
    Matrix4ToEuler of the poses the last one set.  ``paired_at`` applies
    to the first iteration (the closure relax's cache).  Returns (the
    poses [S,4,4] after each iteration, with scan 0's as given, and the
    mean position shift of each)."""
    mats = np.asarray(mats, np.float64)
    theta, pos = m3.matrix4_to_euler(mats)
    cur = m3.euler_to_matrix4(pos, theta) if carry_euler else mats.copy()
    S = len(mats)
    poses, rets = [], []
    while len(rets) < iterations and (len(rets) < at_least or not rets or rets[-1] > epsilon):
        if not carry_euler:
            theta, pos = m3.matrix4_to_euler(cur)
        X = _lum_solve(points_local, cur, links, max_d2, prec, device, None if rets else paired_at)
        corr = _ha_corrections(pos[1:], theta[1:], X)
        pos, theta = pos.copy(), theta.copy()
        pos[1:] -= corr[:, :3]
        theta[1:] -= corr[:, 3:]
        cur = np.concatenate([cur[:1], m3.euler_to_matrix4(pos[1:], theta[1:])])
        rets.append(float(np.linalg.norm(corr[:, :3], axis=1).sum() / S))
        after = cur.copy()
        after[0] = mats[0]
        poses.append(after)
    return poses, rets


def proximity_links(positions, cldist2, loopsize):
    """Graph(int, double, int) of graph.cc:108-130: the chain and every
    (j, k), k - j > loopsize, closer than cldist, in row order."""
    S = len(positions)
    d2 = ((positions[:, None] - positions[None]) ** 2).sum(-1)
    jj, kk = np.triu_indices(S, k=1)
    sel = ((kk - jj) > loopsize) & (d2[jj, kk] < cldist2)
    return [(k - 1, k) for k in range(1, S)] + list(zip(jj[sel].tolist(), kk[sel].tolist()))


class PairingCache:
    """The rule of the closure relax's correspondence cache
    (``tpu3dtk_torch.models.lum_device.CorrCache``, its host
    bookkeeping copied): a link keeps the pairing made at its last
    refresh while its relative pose has moved by at most ``tol_t`` cm
    and ``tol_r`` rad since; a new link is refreshed; slots are numbered
    from 0, grow by doubling from ``slot_cap_min``, and when a call
    brings more new links than free slots, the links absent from it are
    dropped (and refreshed when they return)."""

    def __init__(self, tol_t=0.5, tol_r=2e-3, slot_cap_min=64):
        self.tol_t, self.tol_r, self.cap_min = tol_t, tol_r, slot_cap_min
        self.rel: dict = {}  # link -> relative pose at its last refresh
        self.cap = 0

    def prepare(self, links, mats) -> list:
        """The relative pose each link of this call is paired at."""
        keys = list(dict.fromkeys(tuple(lk) for lk in links))
        new = [k for k in keys if k not in self.rel]
        if len(new) > self.cap - len(self.rel) and self.rel:
            present = set(keys)
            for k in [k for k in self.rel if k not in present]:
                del self.rel[k]
        need = len(self.rel) + len(new)
        cap = max(self.cap_min, self.cap or self.cap_min)
        while cap < need:
            cap *= 2
        self.cap = max(self.cap, cap)
        out = []
        for i, j in links:
            Ti, Tj = mats[i], mats[j]
            R = Ti[:3, :3].T @ Tj[:3, :3]
            t = Ti[:3, :3].T @ (Tj[:3, 3] - Ti[:3, 3])
            old = self.rel.get((i, j))
            if old is not None:
                ang = np.arccos(np.clip((np.einsum("ij,ij->", R, old[:3, :3]) - 1.0) * 0.5, -1.0, 1.0))
                if np.linalg.norm(t - old[:3, 3]) <= self.tol_t and ang <= self.tol_r:
                    out.append(old)
                    continue
            rel = np.eye(4)
            rel[:3, :3], rel[:3, 3] = R, t
            self.rel[(i, j)] = rel
            out.append(rel)
        return out


def graph_balancer(edges, w_edge, first, last, n):
    """elch6D::graph_balancer (elch6D.cc:186-280): weights 0 at first and
    1 at last, interpolated by path length along the shortest crossing
    paths between junctions, edges removed as they are used, then
    propagated into branches."""
    from scipy.sparse import csr_array
    from scipy.sparse.csgraph import dijkstra

    adj = {i: {} for i in range(n)}
    for (u, v), w in zip(edges, w_edge):
        adj[u][v] = min(w, adj[u].get(v, np.inf))
        adj[v][u] = min(w, adj[v].get(u, np.inf))
    weights = np.zeros(n)
    weights[last] = 1.0
    crossings, branches = [first, last], []
    while crossings:
        rows = [(u, v, w) for u, nb in adj.items() for v, w in nb.items()]
        g = csr_array(([r[2] for r in rows], ([r[0] for r in rows], [r[1] for r in rows])), shape=(n, n))
        D, P = dijkstra(g, directed=False, indices=crossings, return_predecessors=True)
        D, P = np.atleast_2d(D), np.atleast_2d(P)
        best, drop = None, []
        arr = np.asarray(crossings)
        for si, s in enumerate(crossings):
            later = arr[si + 1 :]
            reach = P[si, later] >= 0
            if reach.any():
                dd = np.where(reach, D[si, later], np.inf)
                k = int(np.argmin(dd))
                if best is None or dd[k] < best[0]:
                    best = (float(dd[k]), si, int(later[k]))
            elif best is None:
                drop.append(s)
        if best is not None:
            _, si, e = best
            s, dist, prev = crossings[si], D[si], P[si].copy()
        for d in drop:
            branches.append(d)
            crossings.remove(d)
        if best is None:
            continue
        prev[s] = s
        adj[e].pop(prev[e], None)
        adj[prev[e]].pop(e, None)
        i = prev[e]
        while i != s:
            weights[i] = weights[s] + (weights[e] - weights[s]) * dist[i] / dist[e]
            adj[i].pop(prev[i], None)
            adj[prev[i]].pop(i, None)
            if adj[i]:
                crossings.append(i)
            i = prev[i]
        if not adj[s] and s in crossings:
            crossings.remove(s)
        if not adj[e] and e in crossings:
            crossings.remove(e)
    while branches:
        s = branches.pop(0)
        for v in list(adj[s]):
            weights[v] = weights[s]
            if len(adj[v]) > 1:
                branches.append(v)
        for v in list(adj[s]):
            adj[v].pop(s, None)
        adj[s].clear()
    return weights


def elch_slerp(points_local, mats, first, last, edges, max_d2, icp_eps, icp_iters, prec, device):
    """The slerp ELCH closure of (first, last) (elch6Dslerp.cc:93-190)
    over the poses ``mats`` [n,4,4]: edge weights |diag C⁻¹| from each
    edge's Euler LUM covariance, balanced over the graph per translation
    axis and for the rotation; the loop ICP of scans first±2 against
    last-2..last; the correction spread by the weights, the end window
    moved by the ICP's own alignment.  Returns the new poses [n,4,4]."""
    n = len(mats)
    pg = _global(points_local, mats, prec, device)
    W = []
    for i, j in edges:
        C, _ = link_cov(pg[i], pg[j], max_d2, tf32=prec.tf32)
        try:
            W.append(np.abs(np.diag(np.linalg.inv(C))))
        except np.linalg.LinAlgError:
            W.append(np.ones(6))
    W = np.asarray(W)
    weights = [graph_balancer(edges, W[:, g].sum(1), first, last, n) for g in ([0], [1], [2], [3, 4, 5])]
    model = torch.cat(pg[max(0, first - 2) : min(n, first + 3)]).cpu().numpy()
    target = torch.cat(pg[max(0, last - 2) : last + 1]).cpu().numpy()
    align, _ = icp(model, target, np.eye(4), max_d2, icp_eps, icp_iters, prec, device)
    align = m3.orthonormal(align)
    Pl0, Pf0 = mats[last], mats[first]
    Pf0_inv = m3.m4inv(Pf0)
    deltaf = Pf0_inv @ (align @ Pl0) @ m3.m4inv(Pf0_inv @ Pl0)
    dq, dt = m3.matrix4_to_quat(deltaf), deltaf[:3, 3]
    idq = np.array([1.0, 0.0, 0.0, 0.0])
    w = np.stack(weights)  # [4, n]
    delta0 = Pf0 @ m3.m4inv(m3.quat_to_matrix4(m3.slerp(idq, dq, w[3, 0]), dt * w[:3, 0]))
    out = [np.asarray(mats[0], np.float64)]
    for i in range(1, n):
        if last - 2 <= i <= last:
            Ti = delta0 @ Pf0_inv @ align
        else:
            Ti = delta0 @ m3.quat_to_matrix4(m3.slerp(idq, dq, w[3, i]), dt * w[:3, i]) @ Pf0_inv
        out.append(Ti @ mats[i])
    return np.stack(out)
