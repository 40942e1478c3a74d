"""TSDF volume integration — the port of ``tpu3dtk.models.tsdf`` (the
reference's src/tsdf/: SensorPolar3D projective model and TsdSpaceVDB
voxel space driven by scan2tsdf.cc, meshed by vdb2mesh.cc).

A dense voxel block on the device, updated once a scan: for each
measured point, ``samples`` static samples along its sensor ray within
±truncation of the surface update the (tsdf, weight) running averages
through two ``index_add_`` scatters.  On a card these are f32 atomics,
so a voxel's sums may differ from the CPU's by the order of their
additions.  Products feeding a sum round once (``math3d.fma_f32``), as
XLA contracts them in the JAX package.  Memory: two f32 volumes, two f32
accumulators of the same size during an integration (16 bytes a voxel;
:attr:`TsdfVolume.nbytes` is the volumes') and the f64 terms of the
running average's product.  Meshing runs through ``ops.surfacenets`` on
the same device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import math3d

__all__ = ["TsdfParams", "TsdfVolume"]


@dataclasses.dataclass
class TsdfParams:
    voxel: float = 5.0          # cm
    truncation: float = 15.0    # cm (ref TsdSpace truncation radius)
    samples: int = 9            # ray samples across the truncation band
    max_weight: float = 64.0    # running-average clamp


def _linspace_f32(lo, hi, num: int, device) -> torch.Tensor:
    """``jnp.linspace(lo, hi, num)`` for f32 bounds, the JAX formula:
    lo·(1 − i/div) + hi·(i/div), the last sample exactly ``hi``."""
    lo = torch.tensor(lo, dtype=torch.float32, device=device)
    hi = torch.tensor(hi, dtype=torch.float32, device=device)
    if num == 1:
        return lo[None]
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


def _integrate(tsdf, weight, points_g, mask, sensor, origin, voxel: float, trunc: float,
               max_weight: float, samples: int):
    """Scatter one scan into the volume (all f32 on one device):
    ``points_g`` [N,3] global-frame surface points, ``sensor`` [3] the
    global sensor origin.  Returns (tsdf, weight)."""
    nx, ny, nz = tsdf.shape
    dev = tsdf.device
    voxel_t = torch.tensor(voxel, dtype=torch.float32, device=dev)
    trunc_t = torch.tensor(trunc, dtype=torch.float32, device=dev)
    rays = points_g - sensor[None, :]
    depth = math3d.norm3_f32(rays)[:, None]
    dirs = rays / torch.clamp(depth, min=1e-9)
    # samples at signed offsets u in [-trunc, +trunc] around the surface:
    # position x = p - u * dir, sdf(x) = u
    us = _linspace_f32(-np.float32(trunc), np.float32(trunc), samples, dev)
    pos = math3d.fma_f32(-us[None, :, None], dirs[:, None, :], points_g[:, None, :])
    ijk = torch.floor((pos - origin) / voxel_t).to(torch.int32)
    inb = (
        mask[:, None]
        & (ijk >= 0).all(-1)
        & (ijk[..., 0] < nx)
        & (ijk[..., 1] < ny)
        & (ijk[..., 2] < nz)
    )
    flat = (
        ijk[..., 0].clamp(0, nx - 1).to(torch.int64) * ny + ijk[..., 1].clamp(0, ny - 1)
    ) * nz + ijk[..., 2].clamp(0, nz - 1)
    dump = nx * ny * nz
    flat = torch.where(inb, flat, dump).reshape(-1)
    sdf_n = (us / trunc_t)[None, :].expand(points_g.shape[0], -1).reshape(-1)  # [-1, 1]
    inb = inb.reshape(-1)
    acc_t = torch.zeros(dump + 1, dtype=torch.float32, device=dev)
    acc_t.index_add_(0, flat, torch.where(inb, sdf_n, 0.0))
    acc_w = torch.zeros(dump + 1, dtype=torch.float32, device=dev)
    acc_w.index_add_(0, flat, inb.to(torch.float32))
    acc_t = acc_t[:dump].reshape(tsdf.shape)
    acc_w = acc_w[:dump].reshape(tsdf.shape)
    w_new = weight + acc_w
    t_new = torch.where(
        w_new > 0, math3d.fma_f32(tsdf, weight, acc_t) / torch.clamp(w_new, min=1e-9), tsdf
    )
    return t_new, torch.clamp(w_new, max=max_weight)


class TsdfVolume:
    """Dense TSDF block over an axis-aligned region, on ``device`` (None:
    the first CUDA card)."""

    def __init__(self, origin, dims, params: TsdfParams | None = None, device=None):
        if device is None:
            from .. import default_device

            device = default_device()
        self.params = params or TsdfParams()
        self.origin = np.asarray(origin, np.float64)
        self.dims = tuple(int(d) for d in dims)
        self.device = torch.device(device)
        self.tsdf = torch.ones(self.dims, dtype=torch.float32, device=self.device)
        self.weight = torch.zeros(self.dims, dtype=torch.float32, device=self.device)

    @classmethod
    def for_bounds(cls, lo, hi, params: TsdfParams | None = None, device=None):
        params = params or TsdfParams()
        lo = np.asarray(lo, np.float64) - 2 * params.truncation
        hi = np.asarray(hi, np.float64) + 2 * params.truncation
        dims = np.maximum(np.ceil((hi - lo) / params.voxel).astype(int) + 1, 2)
        return cls(lo, tuple(dims), params, device=device)

    @property
    def nbytes(self) -> int:
        """Bytes of the two resident volumes (tsdf and weight); an
        integration adds two accumulators of the same size."""
        return self.tsdf.numel() * 4 * 2

    def integrate(self, points_local, pose, mask=None) -> None:
        """Fuse one scan: local points + global pose (the scan2tsdf per-scan
        loop).  The sensor origin is the pose's translation."""
        p = self.params
        pose = np.asarray(pose)
        pts_g = np.asarray(math3d.transform3(pose, np.asarray(points_local))).astype(np.float32)
        if mask is None:
            mask = np.ones(len(pts_g), bool)
        dev = self.device
        self.tsdf, self.weight = _integrate(
            self.tsdf, self.weight,
            torch.as_tensor(pts_g, device=dev), torch.as_tensor(np.asarray(mask), device=dev),
            torch.as_tensor(pose[:3, 3].astype(np.float32), device=dev),
            torch.as_tensor(self.origin.astype(np.float32), device=dev),
            p.voxel, p.truncation, p.max_weight, p.samples,
        )

    def extract_mesh(self):
        """Zero-surface triangles (the vdb2mesh role), meshed on the
        volume's device.  Returns (vertices [V,3] f64, faces [F,3] int32)
        as numpy arrays."""
        from ..ops.surfacenets import surface_nets

        return surface_nets(self.tsdf, self.weight > 0, origin=self.origin, voxel=self.params.voxel)
