"""Process groups as meshes — the port of ``tpu3dtk.parallel.mesh``.

The reference is single-node (SURVEY §2.8: OpenMP threads + an optional
shared-memory daemon; no distributed backend).  The JAX package adds
named device meshes; on PyTorch a mesh is a ``torch.distributed``
process group, one process a card (or a share of one, see
``parallel.distributed``), and what a sharded path needs of it is the
world size and this process's rank:

- ICP: each rank holds a contiguous slice of the target points; the
  pair statistics are summed over the ranks (``models.minimizers.
  pair_stats(group=)``, ``parallel.icp_shard``);
- LUM: each rank computes a contiguous slice of the links; their
  statistics are summed over the ranks (``models.lum_device.lum_run(
  group=)``, ``parallel.lum_shard``).

:func:`rank_range` is the one split both use, :func:`allsum` the one
sum and :func:`sum_rows` the one split-and-sum of per-link rows.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = [
    "Mesh", "allsum", "comm_device", "default_points_mesh", "group_range", "make_mesh",
    "rank_range", "sum_rows",
]


class Mesh(NamedTuple):
    """A process group with its size and this process's rank in it."""

    group: object  # torch.distributed.ProcessGroup
    size: int
    rank: int


def make_mesh(group=None) -> Mesh:
    """The mesh of ``group`` (default: every process of the initialised
    ``torch.distributed`` job).  Raises when no job is initialised."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call parallel.distributed.initialize() first"
        )
    group = group if group is not None else dist.group.WORLD
    return Mesh(group, dist.get_world_size(group), dist.get_rank(group))


def default_points_mesh():
    """The group drivers pick up automatically: every process of the job
    when one is initialised with more than one rank, else None (a world
    of one runs the unsharded path)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def rank_range(n: int, size: int, rank: int) -> tuple[int, int]:
    """Rank ``rank``'s contiguous share [lo, hi) of n items split over
    ``size`` ranks: ceil(n / size) each, the last ones short or empty
    (the split padded to the world size, the padding dropped)."""
    per = -(-n // size)
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


def group_range(n: int, group) -> tuple[int, int]:
    """:func:`rank_range` of this process in ``group`` (all of [0, n)
    for None)."""
    if group is None:
        return 0, n
    import torch.distributed as dist

    return rank_range(n, dist.get_world_size(group), dist.get_rank(group))


def comm_device(group):
    """Where a collective's tensors must live: the current card under
    NCCL, the host under gloo."""
    import torch
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allsum(group, *parts):
    """The sums of ``parts`` (tensors of one dtype on one device) over the
    ranks of the process ``group``, packed into one ``all_reduce``; the
    parts as they are where ``group`` is None.  Every rank gets the same
    sums."""
    if group is None:
        return parts
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=group)
    out, k = [], 0
    for p in parts:
        out.append(flat[k : k + p.numel()].view(p.shape))
        k += p.numel()
    return tuple(out)


def sum_rows(group, n, rows, *parts):
    """The [n, ...] arrays of which this rank computed the rows ``rows``
    (``parts``, one row each, in that order; the other ranks of ``group``
    computed the rest): each part laid into zeros at its rows, then summed
    over the group with :func:`allsum`.  A row computed on one rank only
    is nonzero there only, so every rank gets every row exactly.  Tensors
    stay on their device; numpy parts come back numpy (summed on
    :func:`comm_device`)."""
    import numpy as np
    import torch

    host = isinstance(parts[0], np.ndarray)
    if host:
        dev = comm_device(group) if group is not None else torch.device("cpu")
        parts = [torch.as_tensor(p, device=dev) for p in parts]
    rows = torch.as_tensor(np.asarray(rows, np.int64), device=parts[0].device)
    full = []
    for p in parts:
        f = p.new_zeros((n,) + tuple(p.shape[1:]))
        f[rows] = p
        full.append(f)
    out = allsum(group, *full)
    return tuple(o.cpu().numpy() for o in out) if host else out
