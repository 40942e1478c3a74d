"""Batched k-nearest-neighbour search — the port of ``tpu3dtk.ops.knn``
(the reference's kd-tree KNN queries behind the normals,
include/slam6d/kdTreeImpl.h:432 ``_KNNSearch``, src/slam6d/normals.cc).

Exact, O(Q·M): the scores of a ``[q_tile, M]`` tile at a time, then
``torch.topk``.  The JAX package leaves this to XLA (no Pallas kernel),
so the port keeps it plain torch on whatever device its tensors are on.
Scores are direct differences (q−m)² per coordinate, not the JAX
package's |q|²+|m|²−2q·m expansion (it cancels in f32): the neighbour
sets agree up to ties at the k-th distance.
"""

from __future__ import annotations

import torch

from .nn import _TILE_ELEMS

__all__ = ["knn_brute"]


def knn_brute(query, qmask, model, mmask, k: int):
    """The k nearest model points of each query point.

    query [Q,3], model [M,3] f32 tensors on one device; masks [Q] / [M]
    bool.  Returns (idx [Q,k] int64, d2 [Q,k] f32), ascending by
    distance.  Masked model points never win while k valid ones exist
    (their d2 is +inf).  Self-matches are not excluded: a cloud queried
    against itself gets each point as its own neighbour 0, as the
    reference's PCA neighbourhood does.  ``qmask`` is part of the
    signature of the JAX function and, as there, does not change the
    result."""
    del qmask
    Q, M = query.shape[0], model.shape[0]
    minf = torch.where(mmask, 0.0, float("inf")).to(model.dtype)
    mt = model.T.contiguous()
    idx = torch.empty((Q, k), dtype=torch.int64, device=query.device)
    d2 = torch.empty((Q, k), dtype=model.dtype, device=query.device)
    step = max(1, _TILE_ELEMS // max(M, 1))
    for s in range(0, Q, step):
        qt = query[s : s + step]
        dx = qt[:, 0:1] - mt[0]
        dy = qt[:, 1:2] - mt[1]
        dz = qt[:, 2:3] - mt[2]
        vals, ids = torch.topk(dx * dx + dy * dy + dz * dz + minf, k, dim=1,
                               largest=False, sorted=True)
        idx[s : s + step] = ids
        d2[s : s + step] = vals
    return idx, d2
