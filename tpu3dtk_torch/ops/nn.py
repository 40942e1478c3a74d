"""Nearest-neighbour correspondence search — the port of
``tpu3dtk.ops.nn`` (the reference's kd-tree ``KDTreeImpl::_FindClosest``,
include/slam6d/kdTreeImpl.h:345-389, as dense batched search).

- :func:`nn_brute`: the plain PyTorch version of the CUDA kernel (K1,
  ``ops/nn_cuda.py``): tiled brute force on exact f32 direct
  differences, running on whatever device its tensors are on.
- :func:`nn_brute_auto`: the dispatch the ICP loop calls — a CUDA tensor
  goes to the hand-written kernel, a CPU tensor to :func:`nn_brute`.
- :func:`prepare_brute_model`: what both need of a model and does not
  change between the iterations of a match (:class:`BruteModel`: the
  masked centre and the centred, packed model), built once per match;
  both functions also take a bare ``(model, mmask)`` and prepare it
  themselves.
- :func:`nn_brute_line`: closest point to the line along each query's
  direction (normal shooting), plain torch as the JAX package leaves it
  to XLA.

Semantics shared with the reference kd-tree: a match is accepted only
if d² is strictly below ``max_dist2`` (testing/kdtree/kdtree.cc:20-27).
Coordinates are centred on the masked model mean before ranking and the
winner's d² is recomputed from the uncentred coordinates, the contract
of the JAX package's ``nn_brute`` and ``nn_brute_mxu``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "BruteModel", "nn_brute", "nn_brute_auto", "nn_brute_line",
    "prepare_brute_model",
]

BIG = 3.4e38  # d2 reported for a masked winner (the JAX package's value)
_TILE_ELEMS = 1 << 24  # [q_tile, M] scores per tile: 64 MB of f32
# on the CPU a tile that stays in cache: the same rows, ~4x faster
_CPU_TILE_ELEMS = 1 << 18


class BruteModel(NamedTuple):
    """Model side of the brute NN, prepared once per match."""

    center: torch.Tensor  # [3] f32 mean of the masked-in model points
    packed: torch.Tensor  # [M, 4] f32: model - center, masked points at +inf, w = 0
    model: torch.Tensor   # [M, 3] f32 ORIGINAL model points
    mmask: torch.Tensor   # [M] bool model validity mask


def prepare_brute_model(model, mmask) -> BruteModel:
    """Centre the model on its masked mean and pack it for the ranking:
    a masked point is stored with +inf coordinates, so its score is +inf
    for every finite query and it can never win (a query whose every
    candidate is masked keeps index 0)."""
    if model.dim() != 2 or model.shape[1] != 3 or mmask.shape != model.shape[:1]:
        raise ValueError(
            f"prepare_brute_model: expected model [M, 3] and mmask [M], got "
            f"{tuple(model.shape)} and {tuple(mmask.shape)}"
        )
    if model.dtype != torch.float32 or mmask.dtype != torch.bool:
        raise TypeError(
            f"prepare_brute_model: expected f32 points and a bool mask, got "
            f"{model.dtype} and {mmask.dtype}"
        )
    center = masked_center(model, mmask)
    packed = torch.zeros((model.shape[0], 4), dtype=torch.float32, device=model.device)
    packed[:, :3] = torch.where(mmask[:, None], model - center, float("inf"))
    return BruteModel(center=center, packed=packed, model=model, mmask=mmask)


def _as_brute_model(model, mmask) -> BruteModel:
    if isinstance(model, BruteModel):
        if mmask is not None:
            raise ValueError("a BruteModel carries its own mask: pass mmask=None")
        return model
    if mmask is None:
        raise ValueError("a bare model needs its mask")
    return prepare_brute_model(model, mmask)


def nn_brute_auto(query, qmask, model, mmask, max_dist2):
    """Exact brute NN, dispatched on the tensors' device: the CUDA kernel
    (``ops.nn_cuda.nn_brute_kernel``) for CUDA tensors, the plain
    :func:`nn_brute` for CPU tensors.  Same contract as :func:`nn_brute`."""
    if query.device.type == "cuda":
        from .nn_cuda import nn_brute_kernel

        return nn_brute_kernel(query, qmask, model, mmask, max_dist2)
    if query.device.type == "cpu":
        return nn_brute(query, qmask, model, mmask, max_dist2)
    raise ValueError(f"no nearest-neighbour engine for device {query.device}")


def masked_center(model, mmask):
    """Mean of the masked-in model points ([3]; 0 when none is)."""
    w = mmask.to(model.dtype)[:, None]
    return (model * w).sum(0) / torch.clamp(w.sum(), min=1.0)


def sq_norm3(d):
    """x² + y² + z², rounded in that order (the kernel's order)."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def accept(query, qmask, model, mmask, idx, max_dist2):
    """Exact d² of each query's chosen model point and the strict gate:
    (idx, d2, found) with d2 = BIG where the winner is masked."""
    d2 = sq_norm3(query - model[idx])
    valid = mmask[idx]
    d2 = torch.where(valid, d2, BIG)
    found = qmask & valid & (d2 < max_dist2)
    return idx, d2, found


def _q_tile(M: int, device) -> int:
    elems = _CPU_TILE_ELEMS if torch.device(device).type == "cpu" else _TILE_ELEMS
    return max(1, elems // max(M, 1))


def nn_brute(query, qmask, model, mmask, max_dist2):
    """Exact NN of each query point among masked model points (the plain
    version of K1).

    query: [Q,3] f32; qmask [Q] bool; the model either as ``model`` [M,3]
    f32 with ``mmask`` [M] bool, or as a :class:`BruteModel` (then
    ``mmask`` is None).  Returns (idx [Q] int64, d2 [Q] f32, found [Q]
    bool) where found requires d2 < max_dist2 (strict) and both masks.
    Ties keep the lowest index.

    Ranking uses (q−m)² per coordinate in f32 — no |q|²+|m|²−2q·m
    expansion (it cancels catastrophically in f32, and ``torch.cdist``
    switches to it above 25 rows)."""
    bm = _as_brute_model(model, mmask)
    Q = query.shape[0]
    qc = query - bm.center
    mc = bm.packed[:, :3].T.contiguous()  # [3, M], masked points at +inf
    idx = torch.empty(Q, dtype=torch.int64, device=query.device)
    step = _q_tile(mc.shape[1], query.device)
    for s in range(0, Q, step):
        qt = qc[s : s + step]
        dx = qt[:, 0:1] - mc[0]
        dy = qt[:, 1:2] - mc[1]
        dz = qt[:, 2:3] - mc[2]
        idx[s : s + step] = torch.argmin(dx * dx + dy * dy + dz * dz, dim=1)
    return accept(query, qmask, bm.model, bm.mmask, idx, max_dist2)


def nn_brute_line(query, qdir, qmask, model, mmask, max_dist2):
    """Closest model point to the *line* through each query along its
    (unit) direction — the reference's ``FindClosestAlongDir`` metric
    d² = |p−x|² − ((p−x)·dir)² (kdTreeImpl.h:390-405), used by
    normal-shooting pairing (searchTree.cc:133-141).

    query: [Q,3]; qdir: [Q,3] unit directions.  Strict acceptance at
    max_dist2 like nn_brute; ranking on centred direct differences, the
    winner's line distance recomputed from uncentred coordinates."""
    Q = query.shape[0]
    center = masked_center(model, mmask)
    qc = query - center
    mc = (model - center).T.contiguous()
    minf = torch.where(mmask, 0.0, float("inf")).to(model.dtype)
    idx = torch.empty(Q, dtype=torch.int64, device=query.device)
    step = _q_tile(model.shape[0], query.device)
    for s in range(0, Q, step):
        qt, dt = qc[s : s + step], qdir[s : s + step]
        dx = qt[:, 0:1] - mc[0]
        dy = qt[:, 1:2] - mc[1]
        dz = qt[:, 2:3] - mc[2]
        proj = dx * dt[:, 0:1] + dy * dt[:, 1:2] + dz * dt[:, 2:3]
        d2l = dx * dx + dy * dy + dz * dz - proj * proj + minf
        idx[s : s + step] = torch.argmin(d2l, dim=1)
    diff = model[idx] - query
    proj = (diff * qdir).sum(1)
    best = sq_norm3(diff) - proj * proj
    valid = mmask[idx]
    best = torch.where(valid, best, BIG)
    found = qmask & valid & (best < max_dist2)
    return idx, best, found
