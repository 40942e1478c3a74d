"""Out-of-core sequential registration — the port of
``tpu3dtk.models.streaming`` (``torchslam --cache-mb``): scans stream
from disk through the byte-budgeted LRU cache (``io.cache.ScanCache``)
instead of residing in RAM, the role of the reference's scanserver
(README.scanserver.md; CacheManager::allocateCacheObject flushes LRU
objects on miss, src/scanserver/cache/cacheManager.cc:79-113).

Window-1 sequential matching only ever needs the previous scan's
reduced points and the current scan's.  Reduction runs inside the
prefetch worker threads, on ``device`` (``ops.reduction.reduce_scan``),
and the cache holds the reduced clouds as host numpy arrays, so
``ScanCache`` counts their bytes; raw file payloads exist only inside a
worker.  Only the current pair lives on the device: each match is one
``icp.icp_pair`` with the model prepared once (kernel K1 on a card).
Peak resident scan bytes stay bounded by the cache budget plus a couple
of in-flight scans, independent of the sequence length.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import math3d
from ..io import frames as frames_io
from ..io.cache import ScanCache, prefetch_scans
from ..io.scandir import PointFilter, RawScan
from ..ops.reduction import reduce_scan as _reduce_scan
from . import icp as icp_mod

__all__ = ["register_streaming"]


def register_streaming(
    directory: str,
    format: str = "uos",
    params: "icp_mod.IcpParams | None" = None,
    point_filter: PointFilter | None = None,
    reduction: tuple[float, int] = (10.0, 1),
    cache_bytes: int = 256 << 20,
    frames_out: str | None = None,
    start: int = 0,
    end: int = -1,
    extrapolate: bool = True,
    cache: ScanCache | None = None,
    device=None,
) -> list[dict]:
    """Register a scan directory sequentially with bounded memory.

    Returns per-scan dicts {identifier, pose [4,4], error, iterations}.
    ``frames_out``: directory to write per-scan ``.frames`` files into
    (each holds the final pose, tagged ICP).  ``device``: where the
    reduction and the matching run (None: the package default, the
    first card)."""
    if device is None:
        from .. import default_device

        device = default_device()
    dev = torch.device(device)
    params = params or icp_mod.IcpParams()
    voxel, nrpts = reduction

    def reduce_scan(raw: RawScan) -> RawScan:
        xyz = np.asarray(raw.channels["xyz"], np.float32)
        if voxel > 0:
            xyz = _reduce_scan(xyz, voxel, nrpts, device=dev)
        return RawScan(
            identifier=raw.identifier,
            channels={"xyz": xyz},
            pose_pos=raw.pose_pos,
            pose_theta=raw.pose_theta,
            directory=raw.directory,
        )

    cache = cache if cache is not None else ScanCache(cache_bytes)
    results: list[dict] = []
    prev_red = None
    prev_pose = None
    prev_org = None
    if frames_out:
        os.makedirs(frames_out, exist_ok=True)

    for raw in prefetch_scans(
        directory, format=format, start=start, end=end,
        point_filter=point_filter, cache=cache, transform=reduce_scan,
    ):
        red = np.asarray(raw.channels["xyz"], np.float32)
        pose_org = math3d.euler_to_matrix4(raw.pose_pos, raw.pose_theta, xp=np)
        if prev_red is None:
            pose = pose_org
            info = {"identifier": raw.identifier, "pose": pose,
                    "error": 0.0, "iterations": 0}
        else:
            if extrapolate:
                delta = prev_pose @ math3d.m4inv(prev_org, xp=np)
                T0 = delta @ pose_org
            else:
                T0 = pose_org
            model_g = np.asarray(
                math3d.transform3(prev_pose, prev_red, xp=np), np.float32
            )
            res = icp_mod.icp_pair(
                torch.as_tensor(model_g, device=dev),
                torch.ones(len(model_g), dtype=torch.bool, device=dev),
                torch.as_tensor(red, device=dev),
                torch.ones(len(red), dtype=torch.bool, device=dev),
                torch.as_tensor(T0, dtype=torch.float32, device=dev),
                max_dist_match2=params.max_dist_match2,
                epsilon=params.epsilon,
                max_iterations=params.max_iterations,
                minimizer=params.minimizer,
                subsample=params.subsample,
            )
            pose = res.T.cpu().numpy().astype(np.float64)
            u, _, vt = np.linalg.svd(pose[:3, :3])
            pose[:3, :3] = u @ vt
            info = {
                "identifier": raw.identifier, "pose": pose,
                "error": float(res.error),
                "iterations": int(res.iterations),
            }
        results.append(info)
        if frames_out:
            cm = math3d.to_colmajor16(pose, xp=np)
            with open(
                frames_io.frames_path(frames_out, raw.identifier), "w"
            ) as f:
                f.write(" ".join(f"{v:.9g}" for v in cm) + " 2\n")
        prev_red = red
        prev_pose = pose
        prev_org = pose_org
    return results
