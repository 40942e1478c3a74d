"""Plane detection — the port of ``tpu3dtk.models.shapes`` (the
reference's ``Hough`` class, src/shapes/hough.cc:82-400, driven by
``bin/planes``; used by ``models.preg6d``).

- :func:`detect_planes`: the standard Hough transform (SHT).  Every
  remaining point votes for every direction of a Fibonacci half sphere
  (``_directions``) into one ``[D·n_rho]`` int32 accumulator on the
  device; the global maximum is refined by iterated PCA on three
  shrinking inlier bands, its inliers are removed, and the next round
  votes again.
- :func:`detect_planes_rht`: the randomized Hough transform, the
  reference's default: batches of random point triples each vote one
  (direction, rho) cell of a coarser accumulator.

The JAX package builds the whole ``[N, D]`` rho matrix at once (17 GB
of f32 at a 270k-point scan and D = 15840).  Here the vote is tiled over
points (:func:`_vote`): a tile's rho, bins and flat ids, then one
``index_add_`` into the accumulator.  Counts are integers, so the result
does not depend on the tile.  Rho is ``x·nx + y·ny + z·nz`` in f32,
elementwise, so no TF32 matmul can round it.

The remaining points stay on the device (f64, and an f32 copy that
votes) and are compacted there after each plane.  The band selections,
means and covariances are f64 as in the JAX package; the 3x3
eigenproblem of each band runs in numpy on the host (9 numbers), as
there, so both packages take the same eigenvector of the same
covariance.  RHT's triples come from the same
``np.random.default_rng(seed)`` draws as in the JAX package and are
gathered on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.metrics import metrics

__all__ = [
    "HoughParams", "Plane", "detect_planes", "detect_planes_rht", "hough_accumulator",
]

# [tile, D] votes a tile: 2^25 on a card (128 MB of f32 rho), a cache-sized
# 2^18 on the CPU
_TILE_ELEMS = 1 << 25
_CPU_TILE_ELEMS = 1 << 18

# metrics timer: an SHT round's vote, up to the host read of its maximum
# (one a round: the read waits for the device)
HOUGH_VOTE = "hough_vote_time"


@dataclasses.dataclass(frozen=True)
class Plane:
    """theta/phi normal + rho, plus inlier stats (ref ConvexPlane)."""

    normal: np.ndarray  # [3] unit
    rho: float  # signed distance from origin (n . p = rho)
    n_inliers: int
    center: np.ndarray  # [3] inlier centroid


@dataclasses.dataclass
class HoughParams:
    n_theta: int = 90  # polar resolution (ref MaxCountTheta-ish)
    n_phi: int = 180  # azimuth resolution
    n_rho: int = 100  # distance bins
    rho_max: float = 2000.0  # cm
    min_inliers: int = 50  # ref MinSizeAllPoints
    max_planes: int = 20  # ref MaxPlanes
    dist_tol: float = 10.0  # inlier band around the plane (cm)


def _directions(n_theta: int, n_phi: int) -> np.ndarray:
    """Quasi-uniform unit normals over the half sphere z > 0 (a
    Fibonacci spiral, the JAX package's design), f64 [n_theta·n_phi, 3]."""
    n = n_theta * n_phi
    k = np.arange(n) + 0.5
    z = k / n
    phi = k * (np.pi * (3.0 - np.sqrt(5.0)))
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def _device(points, device):
    if isinstance(points, torch.Tensor):
        return points.device
    if device is None:
        from .. import default_device

        return default_device()
    return torch.device(device)


def _vote(pts32, dirs_t, n_rho: int, rho_max: float):
    """SHT accumulator [D·n_rho] int32 of f32 points [N,3] against f32
    directions [D,3], on their device, a tile of points at a time.  A
    point's bin in direction d is ``(x·nx + y·ny + z·nz + rho_max) /
    bin_w`` truncated toward zero and clipped to [0, n_rho − 1]."""
    dev = pts32.device
    D = dirs_t.shape[0]
    dT = dirs_t.T.contiguous()
    shift = torch.tensor(rho_max, dtype=torch.float32, device=dev)
    bin_w = torch.tensor((2.0 * rho_max) / n_rho, dtype=torch.float32, device=dev)
    off = torch.arange(D, dtype=torch.int32, device=dev) * n_rho
    acc = torch.zeros(D * n_rho, dtype=torch.int32, device=dev)
    elems = _CPU_TILE_ELEMS if dev.type == "cpu" else _TILE_ELEMS
    step = max(1, elems // D)
    ones = torch.ones(min(step, pts32.shape[0]) * D, dtype=torch.int32, device=dev)
    for s in range(0, pts32.shape[0], step):
        q = pts32[s : s + step]
        rho = q[:, 0:1] * dT[0]
        rho += q[:, 1:2] * dT[1]
        rho += q[:, 2:3] * dT[2]
        rho += shift
        rho /= bin_w
        bins = rho.to(torch.int32).clamp_(0, n_rho - 1)
        bins += off
        acc.index_add_(0, bins.view(-1), ones[: bins.numel()])
    return acc


def hough_accumulator(points, params: HoughParams, device=None):
    """Vote all points into the (direction, rho) accumulator.

    Returns (acc [D, n_rho] int32 numpy, dirs [D, 3] f32 numpy, bin_w),
    as the JAX function does.  ``points``: a tensor (the vote runs on its
    device) or an array (uploaded to ``device``; None: the first card)."""
    dev = _device(points, device)
    pts = torch.as_tensor(points, device=dev).to(torch.float32)
    dirs = _directions(params.n_theta, params.n_phi).astype(np.float32)
    acc = _vote(pts, torch.as_tensor(dirs, device=dev), params.n_rho, params.rho_max)
    bin_w = (2.0 * params.rho_max) / params.n_rho
    return acc.cpu().numpy().reshape(len(dirs), params.n_rho), dirs, bin_w


def _peak(acc):
    """(flat index, votes) of the accumulator's first maximum in row-major
    order, as ``np.argmax`` picks it; one host read."""
    best = acc.argmax()
    best, votes = torch.stack([best, acc[best].to(best.dtype)]).cpu().tolist()
    return best, votes


def _band_stats(rem, n, rho, band):
    """(count, mean [3], covariance [3,3]) of the points of ``rem`` [N,3]
    f64 within ``band`` of the plane n·p = rho, read to the host in one
    transfer.  Masked sums in place of a compaction: the points outside
    add exact zeros."""
    n_t = torch.as_tensor(np.asarray(n, np.float64), device=rem.device)
    sel = ((rem @ n_t - rho).abs() < band).to(torch.float64)
    cnt = sel.sum()
    c = (rem * sel[:, None]).sum(0) / cnt
    cen = (rem - c) * sel[:, None]
    cov = cen.T @ cen / cnt
    out = torch.cat([cnt[None], c, cov.reshape(9)]).cpu().numpy()
    return int(out[0]), out[1:4], out[4:].reshape(3, 3)


def _refine(rem, n0, rho0, band0, params: HoughParams):
    """Iterated PCA on the bands ``geomspace(band0, dist_tol, 3)``: fit the
    plane of the points within the band of the current plane, keep the
    smallest eigenvector's sign toward the current normal.  Returns
    (normal, rho, ok); ``ok`` is False where a band held too few points
    (the fit so far is returned)."""
    n_ref, rho_ref = n0, rho0
    for band in np.geomspace(band0, params.dist_tol, 3):
        cnt, c, cov = _band_stats(rem, n_ref, rho_ref, band)
        if cnt < max(params.min_inliers // 2, 3):
            return n_ref, rho_ref, False
        _w, V = np.linalg.eigh(cov)
        cand = V[:, 0]
        if cand @ n_ref < 0:
            cand = -cand
        n_ref = cand
        rho_ref = float(n_ref @ c)
    return n_ref, rho_ref, True


def _inliers(rem, n, rho, tol):
    """Mask of the points of ``rem`` within ``tol`` of n·p = rho, and
    their count."""
    n_t = torch.as_tensor(np.asarray(n, np.float64), device=rem.device)
    inl = (rem @ n_t - rho).abs() < tol
    return inl, int(inl.sum())


def _plane(rem, n, rho, inl, count):
    return Plane(
        normal=np.asarray(n), rho=rho, n_inliers=count,
        center=rem[inl].mean(0).cpu().numpy(),
    )


def detect_planes(points, params: HoughParams | None = None, device=None) -> list[Plane]:
    """Iterative Hough plane extraction: vote, take the global maximum
    (the first in row-major order), refine by iterated PCA, remove the
    inliers, repeat (ref Hough::SHT + deletePoints).  ``points``: [N,3]
    tensor or array (uploaded to ``device``; None: the first card)."""
    params = params or HoughParams()
    dev = _device(points, device)
    rem = torch.as_tensor(points, device=dev).to(torch.float64)
    dirs32 = _directions(params.n_theta, params.n_phi).astype(np.float32)
    dirs_t = torch.as_tensor(dirs32, device=dev)
    bin_w = (2.0 * params.rho_max) / params.n_rho
    band0 = max(params.dist_tol, bin_w)
    planes: list[Plane] = []
    for _ in range(params.max_planes):
        if rem.shape[0] < params.min_inliers:
            break
        with metrics.time(HOUGH_VOTE):
            acc = _vote(rem.to(torch.float32), dirs_t, params.n_rho, params.rho_max)
            best, votes = _peak(acc)
        if votes < params.min_inliers:
            break
        d_idx, r_idx = divmod(best, params.n_rho)
        n = dirs32[d_idx]
        rho = -params.rho_max + (r_idx + 0.5) * bin_w
        inl, count = _inliers(rem, n, rho, band0)
        if count < params.min_inliers:
            break
        n_ref, rho_ref, _ok = _refine(rem, n, rho, band0, params)
        inl2, count2 = _inliers(rem, n_ref, rho_ref, params.dist_tol)
        if count2 < params.min_inliers:
            rem = rem[~inl]
            continue
        planes.append(_plane(rem, n_ref, rho_ref, inl2, count2))
        rem = rem[~inl2]
    return planes


def _rht_vote(tri, dirs_t, D: int, n_rho: int, bin_w: float, params: HoughParams):
    """Accumulator [D·n_rho] int32 of the triples tri [B,3,3] f32: each
    triple that passes the distanceOK gate (hough.cc:553) votes the cell
    of its normal's nearest direction (hemisphere z ≥ 0) and its rho;
    the others go to a dump bin that is dropped."""
    dev = tri.device
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    v3 = tri[:, 2] - tri[:, 1]
    n = torch.linalg.cross(v1, v2)
    nn_ = torch.linalg.vector_norm(n, dim=1, keepdim=True)
    lens = torch.stack([torch.linalg.vector_norm(v, dim=1) for v in (v1, v2, v3)])
    ok = (
        (nn_[:, 0] > 1e-6)
        & (lens > 3.0 * params.dist_tol).all(0)
        & (lens < 0.25 * params.rho_max).all(0)
    )
    n = n / torch.clamp(nn_, min=1e-12)
    n = torch.where(n[:, 2:3] < 0, -n, n)
    rho = (n * tri[:, 0]).sum(1)
    dT = dirs_t.T
    sim = n[:, 0:1] * dT[0] + n[:, 1:2] * dT[1] + n[:, 2:3] * dT[2]
    di = sim.argmax(1).to(torch.int32)
    shift = torch.tensor(params.rho_max, dtype=torch.float32, device=dev)
    bw = torch.tensor(bin_w, dtype=torch.float32, device=dev)
    ri = ((rho + shift) / bw).to(torch.int32).clamp_(0, n_rho - 1)
    flat = torch.where(ok, di * n_rho + ri, D * n_rho)
    acc = torch.zeros(D * n_rho + 1, dtype=torch.int32, device=dev)
    acc.index_add_(0, flat, torch.ones_like(flat))
    return acc[:-1]


def detect_planes_rht(
    points,
    params: HoughParams | None = None,
    batch: int = 16384,
    acc_threshold: int = 12,
    max_rounds: int = 60,
    seed: int = 0,
    device=None,
) -> list[Plane]:
    """Randomized Hough Transform — the reference's default plane
    detector (``Hough::RHT``, src/shapes/hough.cc:156-210): sample point
    triples, vote their plane cells, extract a plane when a cell passes
    ``acc_threshold``, delete its inliers, repeat.  A round draws
    ``batch`` triples (``rng.integers(0, len(remaining), (batch, 3))``,
    one draw every round, also the rounds that find nothing) and votes
    them all at once on a grid of ``n_theta // 3 × n_phi // 3``
    directions and rho bins 4·dist_tol wide; the SHT's iterated PCA
    refines."""
    params = params or HoughParams()
    dev = _device(points, device)
    rem = torch.as_tensor(points, device=dev).to(torch.float64)
    rng = np.random.default_rng(seed)
    dirs = _directions(max(params.n_theta // 3, 8), max(params.n_phi // 3, 16))
    D = len(dirs)
    n_rho = max(int(2.0 * params.rho_max / (4.0 * params.dist_tol)), 8)
    bin_w = (2.0 * params.rho_max) / n_rho
    dirs_t = torch.as_tensor(dirs.astype(np.float32), device=dev)
    band0 = max(params.dist_tol, bin_w)
    planes: list[Plane] = []
    for _ in range(max_rounds):
        if rem.shape[0] < max(params.min_inliers, 3):
            break
        idx = torch.as_tensor(rng.integers(0, rem.shape[0], (batch, 3)), device=dev)
        best, votes = _peak(_rht_vote(rem[idx].to(torch.float32), dirs_t, D, n_rho, bin_w, params))
        if votes < acc_threshold:
            continue
        n0 = dirs[best // n_rho]
        rho0 = -params.rho_max + (best % n_rho + 0.5) * bin_w
        n_ref, rho_ref, ok = _refine(rem, n0, rho0, band0, params)
        if not ok:
            continue
        inl, count = _inliers(rem, n_ref, rho_ref, params.dist_tol)
        if count < params.min_inliers:
            continue
        planes.append(_plane(rem, n_ref, rho_ref, inl, count))
        rem = rem[~inl]
        if len(planes) >= params.max_planes:
            break
    return planes
