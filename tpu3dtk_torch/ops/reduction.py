"""Voxel-grid point reduction — the port of ``tpu3dtk.ops.reduction``
(the reference's octree reduction, ``BOctTree::GetOctTreeCenter/Random/
Avg``, include/slam6d/Boctree.h:435-492, driven by
``Scan::calcReducedPoints``, src/slam6d/scan.cc:432-687).

Points are hashed to voxel ids, stably sorted, and reduced with segment
ops.  Modes, as in the JAX package:

- nrpts == 0  -> voxel center          (GetOctTreeCenter)
- nrpts == -1 -> mean of voxel points  (GetOctTreeAvg)
- nrpts == n  -> up to n random points per voxel; with ``rm_scatter``
  voxels holding fewer than n points are dropped entirely
  (scan.cc:594-601).

Center and mean modes give the JAX package's points in the same order
(voxel-id order).  Random mode draws its permutation from a
``torch.Generator`` seeded with ``seed`` instead of ``jax.random``, so it
keeps the same number of points per voxel but not the same points.  The
permutation is always drawn on the CPU, so a CPU and a CUDA run of the
port pick the same points.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["voxel_reduce", "reduce_scan"]

_BITS = 20  # bits per axis of voxel id; supports 1M voxels per axis


def _voxel_ids(pts, mask, voxel):
    """Linear voxel id per point; masked points get the max id so they
    sort to the end.  ``voxel`` is a 0-dim tensor on the points' device:
    dividing by a tensor keeps true f32 division (a Python scalar
    divisor may become a multiply by its reciprocal)."""
    origin = torch.where(mask[:, None], pts, float("inf")).amin(0)
    ij = torch.floor((pts - origin) / voxel).to(torch.int64)
    ij = ij.clamp(0, (1 << _BITS) - 2)
    lin = (ij[:, 0] << (2 * _BITS)) | (ij[:, 1] << _BITS) | ij[:, 2]
    lin = torch.where(mask, lin, (1 << 62) - 1)
    return lin, origin


def voxel_reduce(
    pts: torch.Tensor,
    mask: torch.Tensor,
    voxel_size: float,
    *,
    mode: str = "center",
    nrpts: int = 1,
    rm_scatter: bool = False,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduce a padded point set to one (or nrpts) representatives per
    voxel.

    pts: [N, 3] f32; mask: [N] bool; voxel_size: cm.
    mode: "center" | "mean" | "random" (nrpts per voxel; the pick is a
    permutation drawn from the CPU ``generator`` when one is given).
    Returns (out_pts [N, 3], out_mask [N]) — same padded capacity; valid
    entries are compacted to the front.
    """
    n = pts.shape[0]
    dev = pts.device
    if generator is not None and mode == "random":
        # random pick per voxel == first point per voxel after a random
        # permutation (ref GetOctTreeRandom draws rand(nrpts) per leaf)
        perm = torch.randperm(n, generator=generator).to(dev)
        pts = pts[perm]
        mask = mask[perm]

    voxel = torch.tensor(voxel_size, dtype=pts.dtype, device=dev)
    lin, origin = _voxel_ids(pts, mask, voxel)
    order = torch.sort(lin, stable=True).indices
    lin_s = lin[order]
    pts_s = pts[order]
    mask_s = mask[order]

    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = lin_s[1:] != lin_s[:-1]
    head &= mask_s
    seg = torch.cumsum(head, 0) - 1  # voxel index per sorted point
    nvox = int(head.sum())
    out_mask = torch.arange(n, device=dev) < nvox
    if nvox == 0:  # every point masked
        return torch.zeros_like(pts), out_mask
    seg_v = seg[mask_s]  # masked points sort last, so the valid prefix

    if mode == "mean":
        sums = torch.zeros_like(pts_s).index_add_(0, seg_v, pts_s[mask_s])
        cnts = torch.zeros(n, dtype=pts.dtype, device=dev).index_add_(
            0, seg_v, torch.ones_like(seg_v, dtype=pts.dtype)
        )
        out = sums / torch.clamp(cnts, min=1.0)[:, None]
        return torch.where(out_mask[:, None], out, 0.0), out_mask

    if mode == "center":
        # decode voxel center from the first point of each voxel
        rep = pts_s[head]
        ij = torch.floor((rep - origin) / voxel)
        out = torch.zeros_like(pts_s)
        out[:nvox] = (ij + 0.5) * voxel + origin
        return out, out_mask

    if mode == "random":
        # rank within voxel; keep rank < nrpts
        first_idx = torch.nonzero(head).squeeze(1)
        rank = torch.arange(n, device=dev) - first_idx[seg.clamp(min=0)]
        keep = mask_s & (rank < nrpts)
        if rm_scatter and nrpts > 1:
            cnts = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
                0, seg_v, torch.ones_like(seg_v)
            )
            keep &= cnts[seg.clamp(min=0)] >= nrpts
        total = int(keep.sum())
        out = torch.zeros_like(pts_s)
        out[:total] = pts_s[keep]
        return out, torch.arange(n, device=dev) < total

    raise ValueError(f"unknown reduction mode {mode!r}")


def reduce_scan(xyz, voxel_size, nrpts, *, seed: int = 0, device=None):
    """Host convenience wrapper mirroring calcReducedPoints' mode switch
    (scan.cc:588-601).  xyz: numpy [N,3].  Reduces on ``device`` (the
    package default when None) and returns a compacted [Nr,3] numpy f32
    array."""
    if voxel_size <= 0 or len(xyz) == 0:
        return np.asarray(xyz, np.float32).reshape(-1, 3)
    if device is None:
        from .. import default_device

        device = default_device()
    pts = torch.as_tensor(np.asarray(xyz, np.float32), device=device)
    mask = torch.ones(len(pts), dtype=torch.bool, device=device)
    if nrpts == 0:
        out, m = voxel_reduce(pts, mask, voxel_size, mode="center")
    elif nrpts == -1:
        out, m = voxel_reduce(pts, mask, voxel_size, mode="mean")
    else:
        gen = torch.Generator().manual_seed(int(seed))
        out, m = voxel_reduce(
            pts, mask, voxel_size, mode="random", nrpts=int(nrpts),
            generator=gen,
        )
    return out[m].cpu().numpy()
