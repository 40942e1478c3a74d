"""Multi-process GraphSLAM — the port of ``tpu3dtk.parallel.lum_shard``:
the LUM link statistics split over the ranks of a ``torch.distributed``
process group.

The reference parallelizes LUM's per-link covariance loop with OpenMP
threads scattering into shared G/B under a critical section
(lum6Deuler.cc:270-301, SURVEY §2.8 item 2).  Here the link slots are
split into contiguous shares, padded to the world size with the padding
dropped (``parallel.mesh.rank_range``); each rank runs one brute NN call
(kernel K1 on a card) per link of its share against the replicated
points, and one ``all_reduce`` sums the per-link statistics.  Every slot
is computed on one rank only, so the sum is exact: every rank holds the
statistics the unsplit call computes, solves the same system and takes
the same poses.  The split and the sum are ``models.lum_device``'s
(``lum_run(group=)``) and ``parallel.mesh.sum_rows``; the host path
(``LumParams.group``) sums its own engine's rows the same way.  The
functions here keep the JAX package's names.

Not ported: the JAX package's hashed-grid route (``n_buckets``,
``bucket_cap``, ``local_grids``), the XLA hashed cell list (ROADMAP "Do
not port").
"""

from __future__ import annotations

import numpy as np

from ..models import lum_device

__all__ = ["link_covariances_sharded", "lum_run_sharded"]


def link_covariances_sharded(group, points_g, masks, links, max_dist2):
    """(C [L,6,6], CD [L,6], m [L]) numpy for all links, the links split
    over ``group`` (the link statistics ``lum_run(group=)`` sums each
    iteration).  points_g [S,N,3] / masks [S,N] replicated on every
    rank."""
    links = np.asarray(links, np.int64).reshape(-1, 2)
    out = lum_device._link_stats_all(
        points_g, masks, links, np.ones(len(links), bool), max_dist2, group
    )
    return tuple(t.cpu().numpy() for t in out)


def lum_run_sharded(group, *args, **kwargs):
    """``models.lum_device.lum_run`` with its link slots split over
    ``group``: the same result on every rank, and in a world of one
    ``lum_run``'s bit for bit."""
    return lum_device.lum_run(*args, **kwargs, group=group)
