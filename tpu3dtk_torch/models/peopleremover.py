"""Dynamic-object removal by free-space voxel carving — the port of
``tpu3dtk.models.peopleremover`` (the reference's src/peopleremover/:
Schauer/Nüchter change detection; ``walk_voxels`` ray traversal,
common.cc:112; a point is removed where another scan saw *through* its
voxel).

Every ray is sampled at half-voxel steps up to its stop margin and the
visited voxel ids are set in a per-scan free grid; a per-scan bitmask
grid then answers "seen through by any other scan" elementwise.  The JAX
package builds each scan's whole ``[N, K, 3]`` sample tensor (K ≈ 1000
for 50 m rays at 10 cm voxels: gigabytes a scan); here the rays go
through in tiles of at most ``tile_samples`` samples (counter
``peopleremover_ray_tiles``).  The free grid is a boolean OR, so the tile
changes nothing.  The bitmask is int64 (bitwise kernels on CUDA), with
the JAX package's limit of 32 scans a call.  Elementwise arithmetic
rounds as the JAX package's (ray lengths as ``jnp.linalg.norm``, voxel
ids in the precision of the input points).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math3d import norm3_f32
from ..utils.metrics import metrics

__all__ = ["PeopleRemoverParams", "remove_dynamic_points"]

RAY_TILES = "peopleremover_ray_tiles"  # metrics counter: ray tiles sampled
# samples a ray tile holds: 2^25 on a card (~1.3 GB of f64 positions), a
# cache-friendlier 2^20 on the CPU
_TILE_SAMPLES = {"cuda": 1 << 25, "cpu": 1 << 20}


@dataclasses.dataclass
class PeopleRemoverParams:
    voxel_size: float = 10.0  # cm (ref --voxel-size)
    end_offset: float = 1.0  # stop the ray this many voxels before the hit
    # (ref walk_voxels stops before the endpoint so the surface voxel
    # itself is not carved)
    max_range: float | None = None  # ignore rays longer than this
    # per-ray carve-length limiting (ref --maxrange-method, common.h:105
    # NONE/NORMALS/ONENEAREST): "normals" widens the stop margin by
    # 1/|cos(ray, surface normal)| so grazing surfaces are not carved
    # through their own noise band; "1nearest" widens it by each
    # point's nearest-neighbor distance (the local sampling scale)
    maxrange_method: str = "none"
    normal_knearest: int = 12  # ref --normal-knearest


def remove_dynamic_points(
    scan_points: list[np.ndarray],
    scan_origins: list[np.ndarray],
    params: PeopleRemoverParams | None = None,
    device=None,
    tile_samples: int | None = None,
) -> list[np.ndarray]:
    """Per-scan keep masks.

    scan_points[i]: [Ni, 3] global-frame points of scan i; scan_origins[i]:
    [3] its scanner position.  Returns keep_mask[i]: [Ni] bool numpy,
    False for points in voxels a *different* scan saw through (dynamic
    points).  Runs on ``device`` (None: the first CUDA card);
    ``tile_samples`` overrides the samples a ray tile holds."""
    params = params or PeopleRemoverParams()
    if device is None:
        from .. import default_device

        device = default_device()
    dev = torch.device(device)
    tile = tile_samples or _TILE_SAMPLES.get(dev.type, 1 << 20)
    S = len(scan_points)
    if S > 32:
        raise ValueError("max 32 scans per call (bitmask width)")
    vs = float(params.voxel_size)
    allpts = np.concatenate([np.asarray(p) for p in scan_points], axis=0)
    origin = allpts.min(0) - vs
    top = allpts.max(0) + vs
    dims = tuple(int(np.ceil((t - o) / vs)) + 1 for o, t in zip(origin, top))
    nx, ny, nz = dims
    C = nx * ny * nz
    # voxel ids are computed in the precision of the grid origin: f64 for
    # f64 input points, as numpy promotes them in the JAX package
    wdt = torch.float64 if origin.dtype == np.float64 else torch.float32
    origin_t = torch.as_tensor(origin, device=dev).to(wdt)
    hi_ijk = torch.tensor([nx - 1, ny - 1, nz - 1], device=dev)

    def vox_id(pts):
        ij = torch.floor((pts.to(wdt) - origin_t) / vs).to(torch.int32).to(torch.int64)
        ij = torch.minimum(torch.clamp(ij, min=0), hi_ijk)
        return (ij[..., 0] * ny + ij[..., 1]) * nz + ij[..., 2]

    seen_bits = torch.zeros(C, dtype=torch.int64, device=dev)  # per-scan free-space bits
    free = torch.empty(C, dtype=torch.bool, device=dev)
    occupied = []  # voxel ids of each scan's endpoints
    half = np.float32(0.5 * vs)
    for s in range(S):
        pts = torch.as_tensor(np.asarray(scan_points[s], np.float32), device=dev)
        org = torch.as_tensor(np.asarray(scan_origins[s], np.float32), device=dev)
        ray = pts - org
        rlen = norm3_f32(ray)
        if params.max_range is not None:
            valid = rlen < params.max_range
        else:
            valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
        # samples at half-voxel steps up to (len - margin); the margin
        # starts at end_offset voxels and grows per maxrange_method
        margin = torch.full_like(rlen, params.end_offset * vs)
        if params.maxrange_method == "normals":
            from ..ops.normals import estimate_normals_knn

            nrm = estimate_normals_knn(
                pts, torch.ones(len(pts), dtype=torch.bool, device=dev), org,
                k=params.normal_knearest,
            )
            u = ray / torch.clamp(rlen, min=1e-9)[:, None]
            p = nrm * u
            cosang = ((p[:, 0] + p[:, 1]) + p[:, 2]).abs()
            # voxel-diagonal margin: a grazing ray stays inside the
            # surface's voxel slab for ~voxel·sqrt(3)/cos of its length
            margin = margin * np.float32(np.sqrt(3.0)) / torch.clamp(cosang, 0.15, 1.0)
        elif params.maxrange_method == "1nearest":
            from ..ops import knn as knn_ops

            ones = torch.ones(len(pts), dtype=torch.bool, device=dev)
            _idx, d2k = knn_ops.knn_brute(pts, ones, pts, ones, 2)
            margin = torch.maximum(margin, torch.sqrt(torch.clamp(d2k[:, 1], min=0.0)))
        rlen_c = torch.clamp(rlen, min=1e-9)
        tmax = torch.clamp(rlen - margin, min=0.0) / rlen_c
        kmax = int(np.ceil(float(rlen.max()) / (0.5 * vs))) + 1
        tsteps = torch.arange(1, kmax + 1, dtype=torch.float32, device=dev) * half
        free.zero_()
        rows = max(1, tile // kmax)
        for a in range(0, len(pts), rows):
            b = min(a + rows, len(pts))
            t = torch.minimum(tsteps[None, :] / rlen_c[a:b, None], tmax[a:b, None])
            samples = org + ray[a:b, None, :] * t[:, :, None]
            # an invalid ray marks voxel 0, as the JAX package's where(valid, ids, 0) does
            ids = torch.where(valid[a:b, None], vox_id(samples), 0)
            free[ids.reshape(-1)] = True
            metrics.count(RAY_TILES)
        seen_bits |= torch.where(free, 1 << s, 0)
        occupied.append(vox_id(pts))

    masks = []
    for s in range(S):
        other = seen_bits[occupied[s]] & ~(1 << s)
        masks.append((other == 0).cpu().numpy())
    return masks
