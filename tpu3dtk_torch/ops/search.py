"""Batched range/box/segment searches — the port of ``tpu3dtk.ops.search``
(the reference's remaining kd-tree query surface,
include/slam6d/kdTreeImpl.h:491-828: FixedRangeSearch,
fixedRangeSearchAlongDir, AABBSearch, segmentSearch_1NearestPoint,
segmentSearch_all).

Every query is a dense masked reduction on the tensors' device, plain
torch as the JAX package leaves it to XLA.  Variable-size result sets
are capped ``[Q, K]`` blocks with exact counts (callers grow K and run
again when count == K), sorted by distance, with strict ``d² <
max_dist2``.  The K candidates are ranked on f32 direct differences of
centred coordinates, a ``[q_tile, M]`` tile at a time (the JAX package
ranks by the |q|²+|m|²−2q·m expansion, which cancels in f32; the sets
agree up to ties at the K-th distance), and their distances are then
recomputed exactly from the uncentred coordinates, as in the JAX
package.
"""

from __future__ import annotations

import torch

from .nn import _q_tile, masked_center, sq_norm3

__all__ = [
    "fixed_range_search",
    "fixed_range_search_along_dir",
    "aabb_search",
    "segment_search_1nn",
    "segment_search_all",
]

_BIG = 3.4e38


def _dot3(a, b):
    """a·b over the last axis as x + y + z in that order: elementwise
    operations only, so a card and the CPU round alike (a reduction may
    sum in another order)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _top_k(query, qdir, model, mmask, K):
    """Indices [Q, K] of the K model points ranked first for each query:
    by squared distance, or with ``qdir`` by squared distance to the line
    through the query along it.  Masked model points rank last."""
    Q = query.shape[0]
    center = masked_center(model, mmask)
    qc = query - center
    mc = (model - center).T.contiguous()
    minf = torch.where(mmask, 0.0, float("inf")).to(model.dtype)
    idx = torch.empty((Q, K), dtype=torch.int64, device=query.device)
    step = _q_tile(model.shape[0], query.device)
    for s in range(0, Q, step):
        qt = qc[s : s + step]
        dx = qt[:, 0:1] - mc[0]
        dy = qt[:, 1:2] - mc[1]
        dz = qt[:, 2:3] - mc[2]
        score = dx * dx + dy * dy + dz * dz
        if qdir is not None:
            dt = qdir[s : s + step]
            proj = dx * dt[:, 0:1] + dy * dt[:, 1:2] + dz * dt[:, 2:3]
            score = score - proj * proj
        idx[s : s + step] = torch.topk(score + minf, K, dim=1, largest=False).indices
    return idx


def _capped(idx, d2x, qmask, mmask, max_dist2):
    """The capped-K contract: found = both masks and d² < max_dist2
    (strict), count = found a row, rows sorted by distance (found
    first)."""
    d2x = torch.where(mmask[idx], d2x, _BIG)
    found = qmask[:, None] & (d2x < max_dist2)
    count = found.sum(1).to(torch.int32)
    order = torch.argsort(torch.where(found, d2x, _BIG), dim=1, stable=True)
    return (
        torch.take_along_dim(idx, order, dim=1),
        torch.take_along_dim(d2x, order, dim=1),
        torch.take_along_dim(found, order, dim=1),
        count,
    )


def fixed_range_search(query, qmask, model, mmask, max_dist2, K: int = 64):
    """ALL model points within sqrt(max_dist2) of each query
    (kdTreeImpl.h FixedRangeSearch), as capped top-K blocks.

    query [Q,3], model [M,3] f32 with masks [Q] / [M] on one device.
    Returns (idx [Q,K] int64, d2 [Q,K] f32, found [Q,K] bool, count [Q]
    int32).  Exact iff max(count) < K; sorted by distance."""
    idx = _top_k(query, None, model, mmask, K)
    d2x = sq_norm3(query[:, None, :] - model[idx])
    return _capped(idx, d2x, qmask, mmask, max_dist2)


def fixed_range_search_along_dir(query, qdir, qmask, model, mmask, max_dist2, K: int = 64):
    """All model points within line distance sqrt(max_dist2) of the ray
    through each query along qdir [Q,3] (kdTreeImpl.h:491-536
    fixedRangeSearchAlongDir, the normal-shooting range variant).  Same
    capped-K contract as :func:`fixed_range_search`."""
    idx = _top_k(query, qdir, model, mmask, K)
    diff = model[idx] - query[:, None, :]
    proj = _dot3(diff, qdir[:, None, :])
    return _capped(idx, sq_norm3(diff) - proj * proj, qmask, mmask, max_dist2)


def aabb_search(model, mmask, lo, hi):
    """Mask of model points inside the axis-aligned box [lo, hi]
    (kdTreeImpl.h:540-580 AABBSearch; inclusive bounds)."""
    return ((model >= lo) & (model <= hi)).all(1) & mmask


def _segment_d2(p1, p2, model):
    """Squared distance of each model point to the segment p1-p2 (to the
    clamped projection)."""
    seg = p2 - p1
    L2 = torch.clamp(sq_norm3(seg), min=1e-30)
    t = torch.clamp(_dot3(model - p1, seg) / L2, 0.0, 1.0)
    return sq_norm3(model - (p1[None, :] + t[:, None] * seg[None, :]))


def segment_search_1nn(p1, p2, model, mmask, max_dist2):
    """Closest model point to the SEGMENT p1-p2
    (kdTreeImpl.h segmentSearch_1NearestPoint).  Returns 0-dim (idx, d2,
    found) tensors; ties keep the lowest index."""
    d2 = torch.where(mmask, _segment_d2(p1, p2, model), _BIG)
    idx = d2.argmin()
    best = d2[idx]
    return idx, best, best < max_dist2


def segment_search_all(p1, p2, model, mmask, max_dist2):
    """Mask of all model points within sqrt(max_dist2) of the segment
    (kdTreeImpl.h segmentSearch_all)."""
    return mmask & (_segment_d2(p1, p2, model) < max_dist2)
