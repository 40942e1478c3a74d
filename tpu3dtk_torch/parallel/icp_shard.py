"""Multi-process ICP — the port of ``tpu3dtk.parallel.icp_shard``: the
target points split over the ranks of a ``torch.distributed`` process
group, the model replicated, the pair statistics summed over the ranks.

This is the reference's parallel ICP (src/slam6d/icp6D.cc:129-222, after
Langis/Greenspan/Godin "The Parallel Iterative Closest Point
Algorithm"): per-thread partial (n, sum, centroid, Si) accumulators
become per-rank partials summed by ``all_reduce``, the merge the
reference does serially in ``Align_Parallel`` (icp6Dminimizer.h:61-82).

Each rank holds a contiguous slice of the target, padded with masked
points to a multiple of the world size, and runs the NN (kernel K1 on a
card) for its slice only.  The loop is ``models.icp.icp_pair`` with the
group: the same minimizer, pose update and stop tests, so every rank
ends with the same pose, and in a world of one the result is
``icp_pair``'s bit for bit.  The JAX package's hashed cell-list option
(``grid_buckets``) is not ported (ROADMAP "Do not port").
"""

from __future__ import annotations

import torch

from ..models import icp as icp_mod
from .mesh import make_mesh

__all__ = [
    "icp_pair_seq_sharded", "icp_pair_sharded", "icp_step_batch_sharded",
    "shard_target",
]


def shard_target(group, target, tmask, normals=None):
    """This rank's contiguous slice of a target [N,3] with its mask [N]
    (and normals [N,3]): the target padded with masked points to a
    multiple of the group's size, then split into equal slices in rank
    order.  Returns (target, tmask, normals or None)."""
    mesh = make_mesh(group)
    N = target.shape[0]
    rows = -(-N // mesh.size)
    pad = rows * mesh.size - N

    def part(t, fill):
        if pad:
            t = torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), fill)])
        return t[mesh.rank * rows : (mesh.rank + 1) * rows]

    return (
        part(target, 0), part(tmask, False),
        None if normals is None else part(normals, 0),
    )


def icp_pair_sharded(
    group, model, mmask, target_local, tmask, T0, *,
    max_dist_match2, epsilon=1e-5,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    seed: int = 0,
    pairing: str = "closest_point",
    target_normals_local=None,
) -> icp_mod.IcpResult:
    """``models.icp.icp_pair`` with the target split over ``group``.

    model/mmask and the whole target (target_local/tmask and normals)
    are given on every rank; each rank keeps its slice
    (:func:`shard_target`).  Every rank returns the same result."""
    tgt, tm, nrm = shard_target(group, target_local, tmask, target_normals_local)
    return icp_mod.icp_pair(
        model, mmask, tgt, tm, T0,
        max_dist_match2=max_dist_match2, epsilon=epsilon,
        max_iterations=max_iterations, minimizer=minimizer,
        subsample=subsample, seed=seed, pairing=pairing,
        target_normals_local=nrm, group=group,
    )


def icp_step_batch_sharded(
    group, models, mmasks, targets, tmasks, Ts, *,
    max_dist_match2: float, minimizer: str = "quat",
):
    """One ICP iteration over a batch of scan pairs, each pair's target
    split over ``group`` and its statistics summed over the ranks
    (:func:`icp_pair_sharded` for one iteration).

    models [B,M,3], mmasks [B,M], targets [B,N,3] (local frames), tmasks
    [B,N], Ts [B,4,4] current target poses, on every rank.  Returns (Ts
    [B,4,4] after the step, errs [B] f64, n_pairs [B]); a pair with 3
    pairs or fewer keeps its pose.  The JAX package lays the pairs over a
    second ``scans`` mesh axis; here every rank takes part in every pair."""
    res = [
        icp_pair_sharded(
            group, models[b], mmasks[b], targets[b], tmasks[b], Ts[b],
            max_dist_match2=max_dist_match2, max_iterations=1, minimizer=minimizer,
        )
        for b in range(models.shape[0])
    ]
    return (
        torch.stack([r.T for r in res]),
        torch.tensor([r.error for r in res], dtype=torch.float64),
        torch.tensor([r.n_pairs for r in res]),
    )


def icp_pair_seq_sharded(
    group, locals_all, masks_all, mats, lo: int, hi: int, tgt_idx: int, T0,
    max_dist_match2, epsilon, seed: int = 0, *,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    pairing: str = "closest_point",
    window_cap: int = 0,
    normals_all=None,
) -> icp_mod.IcpResult:
    """``models.icp.icp_pair_seq`` with the target scan split over
    ``group``: the model window is built on every rank from the resident
    [S, N, 3] tensors and poses, each rank matches its slice of scan
    ``tgt_idx``.  ``window_cap`` bounds the model window as there."""
    model, mmask = icp_mod._window(locals_all, masks_all, mats, lo, hi, window_cap)
    return icp_pair_sharded(
        group, model, mmask, locals_all[tgt_idx], masks_all[tgt_idx], T0,
        max_dist_match2=max_dist_match2, epsilon=epsilon,
        max_iterations=max_iterations, minimizer=minimizer,
        subsample=subsample, seed=seed, pairing=pairing,
        target_normals_local=None if normals_all is None else normals_all[tgt_idx],
    )
