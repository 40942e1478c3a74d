"""On-device LUM iteration loop — the port of
``tpu3dtk/models/lum_device.py``.

The reference's ``doGraphSlam6D`` (src/slam6d/lum6Deuler.cc:314-477)
iterates: per-link covariance assembly (FillGB3D, lum6Deuler.cc:265-303)
→ sparse Cholesky solve (graphSlam6D.cc:345-366) → per-scan pose update
via Ha⁻¹X (lum6Deuler.cc:375-455).  Here the relaxation keeps its
points and poses on the device; per iteration:

  1. pose matrices from the Euler state (batched euler_to_matrix4),
  2. the global-frame clouds [S,N,3] from the resident local points,
  3. one brute NN call (kernel K1 on the card) per valid link, the link
     covariances reduced for a batch of links together
     (``graphslam.link_covariances``),
  4. G/B assembly by scatter-add into [n+1, n+1, 6, 6] blocks (index n
     is the dump row for the fixed scan 0 and invalid link slots),
  5. a Jacobi-scaled dense solve of the 6n-dim SPD system in f64 while
     it fits in half the device's free memory (:func:`_dense_fits`);
     beyond, the block-Jacobi CG of ``models.pgsolve`` in f64 on the
     device, over the link blocks,
  6. batched Ha⁻¹X pose corrections and the convergence scalar,
  7. ONE host read: the scalar with the new poses, from which the
     caller writes the iteration's frames.

The JAX package runs this as one jitted ``lax.while_loop`` with a pose
history buffer replayed on the host afterwards (a traced loop cannot
call the host); a Python loop reports each iteration as it goes
(``on_iteration``), with the same ``.frames`` records.  Its solve is
f32; this card has native f64, so pose state and solve are f64 and the
Jacobi scaling stays.  The mesh axis is a process group (``group``):
the link statistics are split over its ranks and summed, where the JAX
package sums the G/B blocks.  Not ported: the per-scan hashed local
grids (``build_local_grids``, the ``local_grids`` branch).

S (scan slots) may exceed the real scan count ``n_scans``: slots
beyond it get identity blocks in the system and no correction, so
GraphPipeline's growing prefixes share one resident upload.

The second half is the correspondence cache of the continuous-closure
regime (:class:`CorrCache`, :func:`link_cov_cached`,
:func:`lum_step_cached`).
"""

from __future__ import annotations

import heapq
import os

import numpy as np
import torch

from ..core import math3d
from ..ops import nn as nn_ops
from ..parallel.mesh import group_range, sum_rows
from ..utils.metrics import metrics
from . import graphslam as gs
from . import pgsolve

__all__ = ["CorrCache", "link_cov_cached", "lum_run", "lum_step_cached"]


def _link_stats_all(points_g, masks, links, link_mask, max_dist2, group=None):
    """(C [L,6,6], CD [L,6], m [L]) for all link slots: global-frame
    brute NN over ``points_g`` for the valid slots, zeros for the rest.
    links [L,2] and link_mask [L] are host arrays.

    ``group``: the link slots split over a process group: each rank
    computes the valid slots of its contiguous share
    (``parallel.mesh.group_range``) and ``parallel.mesh.sum_rows`` sums
    the rows over the ranks, every slot nonzero on one rank only, so each
    rank ends with the statistics the unsplit call computes."""
    link_mask = np.asarray(link_mask)
    L = len(link_mask)
    lo, hi = group_range(L, group)
    rows = lo + np.flatnonzero(link_mask[lo:hi])
    C, CD, m = gs.link_covariances(
        points_g, masks, np.asarray(links)[rows], max_dist2
    )
    metrics.count(gs.LUM_LINK_CALLS, len(rows))
    return sum_rows(group, L, rows, C, CD, m)


# metrics counter: iterations of the device block-CG solves
LUM_CG_ITERATIONS = "lum_cg_iterations"


# the dense solve holds about five (6n)² f64 buffers at once: the block
# assembly, its reshaped copy, the scaled copy and the solver's LU
DENSE_BUFFERS = 5


def _dense_fits(n: int, device) -> bool:
    """Whether the dense solve of n variables fits in half the free
    memory of ``device`` (on a card: free plus what torch's allocator
    holds unused; on the host: the available physical memory)."""
    need = DENSE_BUFFERS * (6 * n) ** 2 * 8
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return need <= free // 2


def _solve_cg(links, link_mask, C, CD, n: int):
    """The device block-CG solve (``pgsolve.solve_block_cg``) over the
    valid link slots: X [n,6] f64 on the device."""
    rows = np.flatnonzero(np.asarray(link_mask))
    lk = np.asarray(links, np.int64).reshape(-1, 2)[rows]
    rows_t = torch.as_tensor(rows, device=C.device)
    B = pgsolve.link_rhs(lk, CD[rows_t], n)
    X, iters = pgsolve.solve_block_cg(lk, C[rows_t], B, n)
    metrics.count(LUM_CG_ITERATIONS, iters)
    return X


def _assemble_solve(links, link_mask, C, CD, S: int, n_scans: int):
    """Solve G X = B (FillGB3D + solveSparseCholesky, lum6Deuler.cc:
    265-303 / graphSlam6D.cc:345-366): densely (:func:`_solve_dense`)
    while the system fits on the device, else by the device block-CG
    (:func:`_solve_cg`).  C [L,6,6], CD [L,6] on the device; returns
    X [n,6] f64 there (n = S-1)."""
    if _dense_fits(S - 1, C.device):
        return _solve_dense(links, link_mask, C, CD, S, n_scans)
    return _solve_cg(links, link_mask, C, CD, S - 1)


def _solve_dense(links, link_mask, C, CD, S: int, n_scans: int):
    """Scatter links into block G/B and solve densely in f64.

    Index n = S-1 is the dump row: scan 0 (fixed) and invalid links
    scatter there and the row is dropped before the solve.  Slots for
    scans >= n_scans get identity diagonal blocks so the padded system
    stays non-singular and yields X = 0 for them.  C [L,6,6], CD [L,6]
    on the device; returns X [n,6] f64 there."""
    dev = C.device
    n = S - 1
    links = torch.as_tensor(np.asarray(links), dtype=torch.int64, device=dev)
    link_mask = torch.as_tensor(np.asarray(link_mask), dtype=torch.bool, device=dev)
    a = links[:, 0] - 1
    b = links[:, 1] - 1
    sa = (a >= 0) & link_mask
    sb = (b >= 0) & link_mask
    both = sa & sb
    ai = torch.where(sa, a, n)
    bi = torch.where(sb, b, n)
    abi = torch.where(both, a, n)
    bbi = torch.where(both, b, n)

    C = C.double()
    CD = CD.double()
    Gb = torch.zeros((n + 1, n + 1, 6, 6), dtype=torch.float64, device=dev)
    Bb = torch.zeros((n + 1, 6), dtype=torch.float64, device=dev)
    wa = sa.double()[:, None, None]
    wb = sb.double()[:, None, None]
    wboth = both.double()[:, None, None]
    Gb.index_put_((ai, ai), C * wa, accumulate=True)
    Gb.index_put_((bi, bi), C * wb, accumulate=True)
    Gb.index_put_((abi, bbi), -C * wboth, accumulate=True)
    Gb.index_put_((bbi, abi), -C * wboth, accumulate=True)
    Bb.index_put_((ai,), CD * wa[:, :, 0], accumulate=True)
    Bb.index_put_((bi,), -CD * wb[:, :, 0], accumulate=True)

    # identity diagonal for pad slots and any slot with an empty block
    # row (all its links lost every pair) — keeps G non-singular
    ar = torch.arange(n, device=dev)
    diag = Gb[ar, ar]  # [n,6,6]
    empty = diag.abs().sum(dim=(1, 2)) == 0
    fix = ((ar >= n_scans - 1) | empty).double()
    Gb[ar, ar] = diag + torch.eye(6, dtype=torch.float64, device=dev) * fix[:, None, None]

    G = Gb[:n, :n].permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    B = Bb[:n].reshape(6 * n)
    # Jacobi scaling: translation and rotation columns differ by the
    # squared scene extent (~1e6 in cm²)
    d = torch.sqrt(torch.clamp(torch.diagonal(G), min=1e-20))
    y = torch.linalg.solve(G / (d[:, None] * d[None, :]), B / d)
    return (y / d).reshape(n, 6)


def _ha_corrections(pos, theta, X):
    """Ha⁻¹ X per scan (lum6Deuler.cc:375-436), batched on the device.
    pos/theta: [n,3] for scans 1..n.  Returns [n,6]."""
    xa, ya, za = pos[:, 0], pos[:, 1], pos[:, 2]
    tx, ty = theta[:, 0], theta[:, 1]
    ctx, stx = torch.cos(tx), torch.sin(tx)
    cty, sty = torch.cos(ty), torch.sin(ty)
    z = torch.zeros_like(xa)
    o = torch.ones_like(xa)
    rows = [
        [o, z, z, z, -za * ctx + ya * stx, ya * cty * ctx + za * stx * cty],
        [z, o, z, za, -xa * stx, -xa * ctx * cty + za * sty],
        [z, z, o, -ya, xa * ctx, -xa * cty * stx - ya * sty],
        [z, z, z, o, z, sty],
        [z, z, z, z, stx, ctx * cty],
        [z, z, z, z, ctx, -stx * cty],
    ]
    Ha = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)  # [n,6,6]
    return torch.linalg.solve(Ha, X[..., None])[..., 0]


def _solve_and_update(links, link_mask, C, CD, pos, theta, n_scans: int):
    """Assemble, solve, correct: the new (pos, theta) [S,3] f64 and the
    mean position shift, all still on the device."""
    S = pos.shape[0]
    X = _assemble_solve(links, link_mask, C, CD, S, n_scans)
    corr = _ha_corrections(pos[1:], theta[1:], X)
    valid = (torch.arange(1, S, device=pos.device) < n_scans).to(corr.dtype)
    corr = corr * valid[:, None]
    pos = torch.cat([pos[:1], pos[1:] - corr[:, :3]])
    theta = torch.cat([theta[:1], theta[1:] - corr[:, 3:]])
    ret = torch.linalg.norm(corr[:, :3], dim=1).sum() / max(float(n_scans), 1.0)
    return pos, theta, ret


def _read_state(pos, theta, ret):
    """The one device→host read of an iteration: (pos, theta) [S,3] f64
    numpy and the scalar."""
    S = pos.shape[0]
    flat = torch.cat([pos.reshape(-1), theta.reshape(-1), ret[None]]).cpu().numpy()
    return flat[: 3 * S].reshape(S, 3), flat[3 * S : 6 * S].reshape(S, 3), float(flat[-1])


def _pose_state(pos0, theta0, device):
    return (
        torch.as_tensor(np.asarray(pos0), dtype=torch.float64, device=device),
        torch.as_tensor(np.asarray(theta0), dtype=torch.float64, device=device),
    )


def lum_run(
    locals_pts,       # [S, N, 3] f32 reduced points, local frames
    masks,            # [S, N] bool
    links,            # [L, 2] int host array (masked-out slots anything)
    link_mask,        # [L] bool host array
    pos0,             # [S, 3] Euler positions
    theta0,           # [S, 3] Euler angles
    n_scans: int,     # real scan count (<= S)
    max_dist2: float,
    epsilon: float,   # --epsSLAM mean position shift
    *,
    iterations: int,
    on_iteration=None,
    group=None,
):
    """Run the full LUM relaxation with points and poses on the device.

    ``on_iteration(pos, theta)`` is called after every executed
    iteration with the new pose state as [S,3] f64 host arrays (the
    caller writes that iteration's frames).  Returns (pos [S,3], theta
    [S,3] f64 host arrays, n_iters, final_ret).

    ``group``: a ``torch.distributed`` process group over which the link
    slots are split (the JAX package's ``axis_name``): each rank computes
    its share of the link statistics, one ``all_reduce`` an iteration
    sums them, and every rank solves the same system, so all ranks take
    the same poses, equal to the unsplit run's."""
    pos, theta = _pose_state(pos0, theta0, locals_pts.device)
    pos_h, theta_h = pos.cpu().numpy(), theta.cpu().numpy()
    ret = float("inf")
    it = 0
    while it < iterations and ret > epsilon:
        with metrics.time(gs.LUM_COV):
            mats = math3d.euler_to_matrix4(pos, theta)
            points_g = gs.global_points(locals_pts, mats)
            C, CD, _m = _link_stats_all(points_g, masks, links, link_mask, max_dist2, group)
        with metrics.time(gs.LUM_SOLVE):
            pos, theta, ret_d = _solve_and_update(
                links, link_mask, C, CD, pos, theta, n_scans
            )
            pos_h, theta_h, ret = _read_state(pos, theta, ret_d)
        if on_iteration is not None:
            on_iteration(pos_h, theta_h)
        it += 1
    return pos_h, theta_h, it, ret


# ---------------------------------------------------------------------------
# Correspondence-cached link covariances (continuous-closure fast path)
# ---------------------------------------------------------------------------
#
# The reference recomputes every link's NN pairing on every closure
# (elch6Dslerp.cc:56-85 loops covarianceQuat over ALL edges; slam6D.cc:508
# re-runs doGraphSlam6D over the full prefix graph).  In the continuous-
# closure regime (hannover2 -L 4) that is the dominant cost: each closure
# pays O(links) brute NN passes while the poses have barely moved since
# the previous closure two scans earlier.
#
# NN correspondences depend ONLY on the relative pose T_i^-1 T_j of a
# link's endpoints (distances are rigid-invariant), so they are cached
# per link and refreshed only when the relative pose drifts beyond a
# tolerance.  The covariance STATS (lum_pair_stats: global-frame midpoint
# sums, lum6Deuler.cc:141-232) are recomputed EXACTLY from the current
# global poses every call — only the argmin is reused, so the result
# equals the uncached path up to pairs whose NN assignment flipped within
# the drift tolerance (distance error bounded by 2*(dt + r*dtheta)).


def link_cov_cached(locals_pts, masks, mats, links, link_mask, cache,
                    stale_idx, n_stale, max_dist2):
    """(C, CD, m), slot-ordered [L, ...], with cached correspondences —
    the ELCH edge-covariance fast path and the body of the cached LUM
    step.  ``links``, ``link_mask``, ``stale_idx``, ``n_stale`` are what
    ``cache.prepare`` returned.  The NN of the stale link slots is
    refreshed (one K1 call each, written into the cache's resident rows
    in place); then the statistics of the VALID slots come from the
    cached pairings at the current poses, ``LINK_CHUNK`` slots at a time
    so the [chunk, N, 3] gathers stay bounded."""
    points_g = gs.global_points(locals_pts, mats)
    md2 = float(np.float32(max_dist2))
    links = np.asarray(links, np.int64)
    for sl in np.asarray(stale_idx)[:n_stale].tolist():
        i, j = links[sl].tolist()
        idx, _d2, found = nn_ops.nn_brute_auto(
            points_g[j], masks[j], points_g[i], masks[i], md2
        )
        cache.idx[sl] = idx.to(torch.int32)
        cache.found[sl] = found

    rows = np.flatnonzero(np.asarray(link_mask))
    L = len(link_mask)
    dev = points_g.device
    C = torch.zeros((L, 6, 6), dtype=torch.float32, device=dev)
    CD = torch.zeros((L, 6), dtype=torch.float32, device=dev)
    m = torch.zeros(L, dtype=torch.float32, device=dev)
    for c0 in range(0, len(rows), gs.LINK_CHUNK):
        chunk = rows[c0 : c0 + gs.LINK_CHUNK]
        sl = torch.as_tensor(chunk, device=dev)
        a, b = gs.gather_pairs(
            points_g, torch.as_tensor(links[chunk], device=dev), cache.idx[sl].long()
        )
        d2 = ((a - b) ** 2).sum(-1)
        # NOT the strict gate of ops.nn.accept: a cached pair stays while
        # its CURRENT distance is <= max_dist2 (the JAX package's
        # lum_device.py:365 has it non-strict, and so does the port)
        found = cache.found[sl] & (d2 <= md2)
        C[sl], CD[sl], m[sl] = gs.lum_pair_stats(a, b, found)
    return C, CD, m


def lum_step_cached(locals_pts, masks, links, link_mask, pos0, theta0,
                    n_scans: int, max_dist2, cache, stale_idx, n_stale):
    """ONE LUM iteration (the per-closure doGraphSlam6D(gr, scans, 1),
    slam6D.cc:508) with cached correspondences: refresh stale links →
    exact stats → assemble → dense solve → pose update, one host read.

    Returns (pos [S,3], theta [S,3] f64 host arrays, ret)."""
    pos, theta = _pose_state(pos0, theta0, locals_pts.device)
    with metrics.time(gs.LUM_COV):
        mats = math3d.euler_to_matrix4(pos, theta)
        C, CD, _m = link_cov_cached(
            locals_pts, masks, mats, links, link_mask, cache, stale_idx,
            n_stale, max_dist2,
        )
    with metrics.time(gs.LUM_SOLVE):
        pos, theta, ret = _solve_and_update(
            links, link_mask, C, CD, pos, theta, n_scans
        )
        return _read_state(pos, theta, ret)


class CorrCache:
    """Host-side bookkeeping for the correspondence cache: persistent
    slot assignment per link, per-slot relative pose at the last NN
    refresh, and the resident [L, N] idx/found device tensors.

    ``tol_t`` (cm) / ``tol_r`` (rad): relative-pose drift beyond which a
    link's correspondences are recomputed.  New links are always stale.

    Slots are recycled: when a call brings more new links than there are
    free slots, the slots of links absent from that call's graph are
    given back first, and the tensors grow (doubling) only when that is
    not enough.  So L stays below twice the largest link set of any one
    call plus ``slot_cap_min``, and :meth:`resident_bytes` says what the
    tensors hold (5 bytes a point and slot).  The JAX package never
    evicts a slot.
    """

    def __init__(self, n_points: int, tol_t: float = 0.5,
                 tol_r: float = 2e-3, slot_cap_min: int = 64, device=None):
        self.N = int(n_points)
        self.tol_t = float(tol_t)
        self.tol_r = float(tol_r)
        self.slot_cap_min = int(slot_cap_min)
        self.device = gs._resolve_device(device)
        self.slots: dict = {}
        self._free: list = []  # heap of unassigned slot numbers
        self.L = 0
        self.idx = None
        self.found = None
        self.rel = None  # [L, 4, 4] f64 relative pose at last refresh
        self.n_refresh = 0
        self.n_reuse = 0
        self.n_evicted = 0

    def resident_bytes(self) -> int:
        """Bytes of the idx (int32) and found (bool) device tensors."""
        return self.L * self.N * 5

    def _grow(self, need: int) -> None:
        L2 = max(self.slot_cap_min, self.L or self.slot_cap_min)
        while L2 < need:
            L2 *= 2
        if L2 == self.L:
            return
        idx2 = torch.zeros((L2, self.N), dtype=torch.int32, device=self.device)
        fnd2 = torch.zeros((L2, self.N), dtype=torch.bool, device=self.device)
        rel2 = np.tile(np.eye(4), (L2, 1, 1))
        if self.L:
            idx2[: self.L] = self.idx
            fnd2[: self.L] = self.found
            rel2[: self.L] = self.rel
        for sl in range(self.L, L2):
            heapq.heappush(self._free, sl)
        self.idx, self.found, self.rel, self.L = idx2, fnd2, rel2, L2

    def _assign(self, keys: list) -> set:
        """Give every new link a slot (the lowest free one); returns the
        set of new keys."""
        new = [k for k in dict.fromkeys(keys) if k not in self.slots]
        if len(new) > len(self._free) and self.slots:
            present = set(keys)
            for k in [k for k in self.slots if k not in present]:
                heapq.heappush(self._free, self.slots.pop(k))
                self.n_evicted += 1
        self._grow(len(self.slots) + len(new))
        for k in new:
            self.slots[k] = heapq.heappop(self._free)
        return set(new)

    def prepare(self, links: "np.ndarray", mats: "np.ndarray"):
        """links [E,2] int, mats [n,4,4] f64 current poses.  Returns
        (links_pad [L,2] i32, link_mask [L] bool, stale_idx [L] i32,
        n_stale) and records the refreshed relative poses.  An empty
        link set gives all-false masks and nothing stale."""
        links = np.asarray(links, np.int64).reshape(-1, 2)
        E = len(links)
        keys = [tuple(l) for l in links.tolist()]
        new_set = self._assign(keys)
        slot = np.array([self.slots[k] for k in keys], np.int64)
        links_pad = np.zeros((self.L, 2), np.int32)
        link_mask = np.zeros(self.L, bool)
        links_pad[slot] = links.astype(np.int32)
        link_mask[slot] = True

        Ti = mats[links[:, 0]]
        Tj = mats[links[:, 1]]
        Ri = Ti[:, :3, :3]
        rel_R = np.einsum("lji,ljk->lik", Ri, Tj[:, :3, :3])
        rel_t = np.einsum(
            "lji,lj->li", Ri, Tj[:, :3, 3] - Ti[:, :3, 3]
        )
        old_R = self.rel[slot, :3, :3]
        old_t = self.rel[slot, :3, 3]
        dt = np.linalg.norm(rel_t - old_t, axis=1)
        tr = np.einsum("lij,lij->l", rel_R, old_R)
        ang = np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0))
        known = np.array([k not in new_set for k in keys], bool)
        fresh_rel = known & (dt <= self.tol_t) & (ang <= self.tol_r)
        stale = ~fresh_rel
        stale_slots = slot[stale]
        self.n_refresh += int(stale.sum())
        self.n_reuse += int(fresh_rel.sum())
        rel_new = np.tile(np.eye(4), (int(stale.sum()), 1, 1))
        rel_new[:, :3, :3] = rel_R[stale]
        rel_new[:, :3, 3] = rel_t[stale]
        self.rel[stale_slots] = rel_new
        stale_idx = np.zeros(self.L, np.int32)
        stale_idx[: len(stale_slots)] = stale_slots.astype(np.int32)
        return links_pad, link_mask, stale_idx, int(stale.sum())
