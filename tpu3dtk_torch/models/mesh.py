"""Surface reconstruction from oriented points — the port of
``tpu3dtk.models.mesh`` (the reference's src/mesh/recon.cc: normals,
screened Poisson, exportMesh .obj).

- :func:`reconstruct_imls`: an IMLS implicit f(x) = Σ w_i(x) n_i·(x − p_i)
  / Σ w_i with Gaussian weights over the k nearest samples of every grid
  node: a brute k-NN (``ops.knn.knn_brute``) of node chunks against all
  points, O(nodes × points) pairs (``imls_pairs`` counts them), then
  surface nets.
- :func:`reconstruct_poisson`: the screened Poisson equation (∆ − α) χ =
  ∇·V on a dense grid: trilinear splat of the normals (``index_add_``;
  f32 atomics on a card), central-difference divergence, one FFT, the
  division by the 7-point Laplacian's symbol and the inverse FFT.  As in
  the JAX package, whose x64 flag makes the symbol f64, the forward FFT
  is complex64 and the division and inverse FFT complex128.

Plain torch on the device of the points; fields stay there and are
meshed there (``ops.surfacenets``).  Normals, where not given, come from
``ops.normals.estimate_normals_knn``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math3d import fma_f32
from ..ops import knn as knn_ops
from ..utils.metrics import metrics

__all__ = ["MeshParams", "PoissonParams", "imls_field", "imls_grid", "poisson_field",
           "poisson_grid", "reconstruct_imls", "reconstruct_poisson"]

IMLS_PAIRS = "imls_pairs"  # metrics counter: grid nodes x points ranked by the IMLS k-NN


@dataclasses.dataclass
class MeshParams:
    voxel: float = 8.0       # grid resolution (cm)
    k: int = 12              # neighbors per field evaluation
    bandwidth: float = 2.0   # Gaussian h, in voxel units
    max_dist: float = 4.0    # field trusted within this many voxels
    # of the nearest sample (outside: unseen)


def _device(points, device) -> torch.device:
    if isinstance(points, torch.Tensor):
        return points.device
    if device is not None:
        return torch.device(device)
    from .. import default_device

    return default_device()


def _field_chunked(grid_pts, points, normals, h2: float, trust_d2: float, k: int,
                   chunk: int = 8192):
    """IMLS field on grid nodes [G,3], ``chunk`` nodes at a time (all f32
    tensors on one device).  Returns (f [G], valid [G])."""
    G = grid_pts.shape[0]
    dev = grid_pts.device
    mask = torch.ones(points.shape[0], dtype=torch.bool, device=dev)
    h2 = torch.tensor(h2, dtype=torch.float32, device=dev)
    f = torch.empty(G, dtype=torch.float32, device=dev)
    valid = torch.empty(G, dtype=torch.bool, device=dev)
    for s in range(0, G, chunk):
        q = grid_pts[s: s + chunk]
        idx, d2 = knn_ops.knn_brute(q, None, points, mask, k)
        p = points[idx]  # [c, k, 3]
        n = normals[idx]
        w = torch.exp(-d2 / h2)  # [c, k]
        sd = (n * (q[:, None, :] - p)).sum(-1)
        f[s: s + chunk] = (w * sd).sum(1) / torch.clamp(w.sum(1), min=1e-20)
        valid[s: s + chunk] = d2[:, 0] < trust_d2
    metrics.count(IMLS_PAIRS, float(G) * points.shape[0])
    return f, valid


def imls_grid(points, params: MeshParams):
    """(origin [3] f32, dims [3]) of the IMLS grid over f32 points [N,3]:
    the cloud's bounds padded by two voxels."""
    lo = points.min(0) - 2 * params.voxel
    hi = points.max(0) + 2 * params.voxel
    return lo, np.maximum(np.ceil((hi - lo) / params.voxel).astype(int) + 1, 2)


def imls_field(points, normals, params: MeshParams | None = None, device=None):
    """Evaluate the IMLS field on a regular grid over the cloud bounds.
    ``points`` / ``normals`` [N, 3]: tensors (the work runs on their
    device) or arrays (uploaded to ``device``; None: the first CUDA card).
    Returns (field [X,Y,Z] f32 tensor, valid [X,Y,Z] bool tensor, origin
    [3] f32 numpy, voxel)."""
    params = params or MeshParams()
    dev = _device(points, device)
    pts = np.asarray(points.cpu() if isinstance(points, torch.Tensor) else points, np.float32)
    lo, dims = imls_grid(pts, params)
    xs = lo[0] + params.voxel * np.arange(dims[0])
    ys = lo[1] + params.voxel * np.arange(dims[1])
    zs = lo[2] + params.voxel * np.arange(dims[2])
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    grid = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    h2 = (params.bandwidth * params.voxel) ** 2
    trust = (params.max_dist * params.voxel) ** 2
    nrm = normals.to(dev, torch.float32) if isinstance(normals, torch.Tensor) else \
        torch.as_tensor(np.asarray(normals, np.float32), device=dev)
    f, valid = _field_chunked(
        torch.as_tensor(grid, device=dev), torch.as_tensor(pts, device=dev), nrm,
        float(np.float32(h2)), float(np.float32(trust)), params.k,
    )
    shape = tuple(int(d) for d in dims)
    return f.reshape(shape), valid.reshape(shape), lo, params.voxel


def _normals_for(pts: np.ndarray, k: int, dev) -> torch.Tensor:
    """k-NN normals of f32 points [N,3] on ``dev``, facing a viewpoint far
    above the cloud (outward-ish), as the JAX package's reconstructions
    estimate them."""
    from ..ops.normals import estimate_normals_knn

    center = pts.mean(0) + np.array([0.0, 1e6, 0.0])
    return estimate_normals_knn(
        torch.as_tensor(pts, device=dev), torch.ones(len(pts), dtype=torch.bool, device=dev),
        torch.as_tensor(center.astype(np.float32), device=dev), k=k,
    )


def reconstruct_imls(points, normals=None, params: MeshParams | None = None, device=None):
    """Oriented cloud → triangle mesh (the recon.cc pipeline: normals
    estimated when absent, the implicit fit, meshing).  Returns
    (vertices [V,3] f64, faces [F,3] int32) as numpy arrays."""
    from ..ops.surfacenets import surface_nets

    params = params or MeshParams()
    dev = _device(points, device)
    pts = np.asarray(points, np.float32)
    if normals is None:
        normals = _normals_for(pts, max(params.k, 12), dev)
    field, valid, origin, voxel = imls_field(pts, normals, params, device=dev)
    return surface_nets(field, valid, origin=origin, voxel=voxel)


# ---------------------------------------------------------------------------
# Screened Poisson reconstruction (ref src/mesh/poisson.cc + 3rdparty/poisson)
# ---------------------------------------------------------------------------
#
# The reference wraps Kazhdan's octree-FEM PoissonRecon.  As in the JAX
# package, the same PDE (find the indicator chi whose gradient matches the
# splatted normal field V: (laplacian - alpha) chi = div V) is solved on a
# dense grid in the spectral domain.  The screening term alpha anchors the
# DC mode and pulls chi to zero away from the data (Kazhdan & Hoppe 2013).


@dataclasses.dataclass
class PoissonParams:
    grid: int = 128          # dense grid resolution per axis
    screen: float = 4.0      # screening weight (relative, see alpha)
    margin: float = 0.08     # bbox margin fraction
    trim_dist: float = 3.0   # extract only within this many voxels of
    # a sample (<=0: full grid, fully watertight)


def _corners(idx_f, G: int):
    """For each of the 8 trilinear corners: (weight [N] f32, flat cell
    index [N]) of fractional grid coordinates [N,3]."""
    base = torch.floor(idx_f).to(torch.int32)
    frac = idx_f - base
    for corner in range(8):
        off = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1],
                           dtype=torch.int32, device=idx_f.device)
        t = torch.where(off[None, :] == 1, frac, 1.0 - frac)
        w = t[:, 0] * t[:, 1] * t[:, 2]
        cell = torch.clamp(base + off[None, :], 0, G - 1).to(torch.int64)
        yield w, (cell[:, 0] * G + cell[:, 1]) * G + cell[:, 2]


def _trilinear_splat(idx_f, values, G: int):
    """Scatter-add ``values`` [N, C] at fractional grid coords [N, 3]."""
    out = torch.zeros((G * G * G, values.shape[1]), dtype=torch.float32, device=idx_f.device)
    for w, flat in _corners(idx_f, G):
        out.index_add_(0, flat, w[:, None] * values)
    return out.reshape(G, G, G, -1)


def _trilinear_sample(vol, idx_f):
    acc = torch.zeros(idx_f.shape[0], dtype=vol.dtype, device=vol.device)
    flat_vol = vol.reshape(-1)
    for w, flat in _corners(idx_f, vol.shape[0]):
        acc = fma_f32(w, flat_vol[flat], acc)
    return acc


def poisson_grid(points, params: PoissonParams):
    """(origin [3] f64, voxel) of the Poisson grid over f64 points [N,3]:
    the cloud's longest side plus ``margin`` of it on each end, over
    ``grid`` - 1 cells."""
    lo = points.min(0)
    span = float((points.max(0) - lo).max())
    pad = params.margin * span
    return lo - pad, (span + 2 * pad) / (params.grid - 1)


def poisson_field(points, normals, params: PoissonParams | None = None, device=None):
    """Solve the screened Poisson equation for the indicator field.
    ``points`` / ``normals`` [N, 3] arrays (or tensors), uploaded to
    ``device`` (None: the tensors' device, else the first CUDA card).
    Returns (chi [G,G,G] f32 tensor with the iso level already
    subtracted, occupancy [G,G,G] f32 tensor, origin [3] f64 numpy,
    voxel)."""
    params = params or PoissonParams()
    dev = _device(points, device)
    G = params.grid
    pts = np.asarray(points.cpu() if isinstance(points, torch.Tensor) else points, np.float64)
    nrm = np.asarray(normals.cpu() if isinstance(normals, torch.Tensor) else normals, np.float64)
    origin, voxel = poisson_grid(pts, params)

    idx_f = torch.as_tensor(((pts - origin) / voxel).astype(np.float32), device=dev)
    nj = torch.as_tensor(nrm.astype(np.float32), device=dev)
    splat = _trilinear_splat(
        idx_f, torch.cat([nj, torch.ones((len(pts), 1), dtype=torch.float32, device=dev)], 1), G
    )
    V = splat[..., :3]
    occ = splat[..., 3].contiguous()

    # divergence by central differences (h = 1 voxel; the scale does not
    # move the zero level set)
    div = torch.zeros((G, G, G), dtype=torch.float32, device=dev)
    for ax in range(3):
        div = div + 0.5 * (torch.roll(V[..., ax], -1, dims=ax) - torch.roll(V[..., ax], 1, dims=ax))

    # spectral solve with the symbol of the 7-point discrete Laplacian
    k = torch.arange(G, dtype=torch.float64, device=dev)
    lam1 = 2.0 * torch.cos(2.0 * np.pi * k / G) - 2.0
    lam = lam1[:, None, None] + lam1[None, :, None] + lam1[None, None, :]
    alpha = params.screen * (2.0 * np.pi / G) ** 2
    denom = lam - alpha
    spec = torch.fft.fftn(div).to(torch.complex128) / denom  # complex64 FFT, complex128 division
    chi = torch.fft.ifftn(spec).real.to(torch.float32)

    # iso level: the mean indicator at the samples (PoissonRecon's iso-value)
    iso = _trilinear_sample(chi, idx_f).mean()
    return chi - iso, occ, origin, float(voxel)


def reconstruct_poisson(points, normals=None, params: PoissonParams | None = None, device=None):
    """Oriented cloud → triangle mesh by the dense screened-Poisson solve
    (the reference's bin/poisson pipeline, src/mesh/poisson.cc).  Returns
    (vertices [V,3] f64, faces [F,3] int32) as numpy arrays."""
    from ..ops.surfacenets import surface_nets

    params = params or PoissonParams()
    dev = _device(points, device)
    pts = np.asarray(points, np.float32)
    if normals is None:
        normals = _normals_for(pts, 12, dev)
    chi, occ, origin, voxel = poisson_field(pts, normals, params, device=dev)
    valid = None
    if params.trim_dist > 0:
        from scipy.ndimage import binary_dilation

        valid = binary_dilation((occ > 0).cpu().numpy(), iterations=int(params.trim_dist))
    return surface_nets(chi, valid, origin=origin, voxel=voxel)
