"""2D occupancy grids from registered scans — the port of
``tpu3dtk.models.grid2d`` (ref src/grid/2DGridder.cc + scanGrid/parcel
machinery, SURVEY §2.6: project scans to 2D occupancy maps with
free-space counting along rays).

Points project to (x, z) cells (y-up frame); rays from the scanner
position accumulate free-space counts via the same parametric sampling
as the peopleremover; occupancy = hits vs visits.  The JAX package builds
each scan's whole ``[N, K, 2]`` sample array (K ≈ 1000 for 50 m rays at
10 cm cells); here the rays go through in tiles of at most
``tile_samples`` samples (counter ``grid2d_ray_tiles``).  The counts are
int32 scatter-adds, exact in any order, so the tile changes nothing.

Arithmetic rounds as the JAX package's eager ops do: the points, the
rays, their lengths (``jnp.linalg.norm`` of 2-vectors:
sqrt(fma(z, z, x·x))), the ray parameters and the samples are f32; a
cell id subtracts the f64 grid origin from them, so it is taken in f64.
The writers are numpy copies with byte-identical files;
``extract_gridlines`` takes the f32 rho of ``jnp.dot`` (fma(y, s, x·c))
and votes on the device, with the segment walk on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.math3d import fma_f32
from ..utils.metrics import metrics

__all__ = [
    "Grid2DParams", "OccupancyGrid", "make_occupancy_grid", "write_gnuplot", "write_world",
    "extract_gridlines",
]

RAY_TILES = "grid2d_ray_tiles"  # metrics counter: ray tiles sampled
# samples a ray tile holds: 2^25 on a card, 2^20 on the CPU
_TILE_SAMPLES = {"cuda": 1 << 25, "cpu": 1 << 20}


@dataclasses.dataclass
class Grid2DParams:
    resolution: float = 10.0  # cm per cell (ref --resolution)
    y_min: float | None = None  # height band filter (ref --minHeight)
    y_max: float | None = None
    count_free: bool = True  # ray-carve free space


@dataclasses.dataclass
class OccupancyGrid:
    origin: np.ndarray  # [2] world coords of cell (0,0) (x, z)
    resolution: float
    hits: np.ndarray  # [W, H] int32
    visits: np.ndarray  # [W, H] int32 (hits + free-space traversals)

    @property
    def occupancy(self) -> np.ndarray:
        """P(occupied): hits / visits, -1 for never-seen (ref grid
        convention of unknown cells)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            p = self.hits / np.maximum(self.visits, 1)
        p = np.where(self.visits > 0, p, -1.0)
        return p

    def write_pgm(self, path: str) -> None:
        """Grey occupancy image (ref writeGrid ppm/pgm outputs)."""
        occ = self.occupancy
        img = np.where(occ < 0, 128, (1.0 - occ) * 255).astype(np.uint8)
        with open(path, "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
            f.write(img.tobytes())


def make_occupancy_grid(
    scan_points: list[np.ndarray],
    scan_origins: list[np.ndarray],
    params: Grid2DParams | None = None,
    device=None,
    tile_samples: int | None = None,
) -> OccupancyGrid:
    """Build a global 2D occupancy grid from global-frame points.

    scan_points[i]: [Ni, 3]; scan_origins[i]: [3].  Runs on ``device``
    (None: the first CUDA card); ``tile_samples`` overrides the samples a
    ray tile holds.  Returns numpy counts.
    """
    params = params or Grid2DParams()
    if device is None:
        from .. import default_device

        device = default_device()
    dev = torch.device(device)
    tile = tile_samples or _TILE_SAMPLES.get(dev.type, 1 << 20)
    res = params.resolution
    pts_all = []
    for p in scan_points:
        p = np.asarray(p)
        keep = np.ones(len(p), bool)
        if params.y_min is not None:
            keep &= p[:, 1] >= params.y_min
        if params.y_max is not None:
            keep &= p[:, 1] <= params.y_max
        pts_all.append(p[keep])
    cat = np.concatenate(pts_all, axis=0)
    xz = cat[:, [0, 2]]
    orgs = np.stack([np.asarray(o)[[0, 2]] for o in scan_origins])
    origin = np.minimum(xz.min(0), orgs.min(0)) - res
    top = np.maximum(xz.max(0), orgs.max(0)) + res
    W = int(np.ceil((top[0] - origin[0]) / res)) + 1
    H = int(np.ceil((top[1] - origin[1]) / res)) + 1
    # f32 values minus the f64 numpy origin promote to f64 (x64), so the
    # cell of a value is taken in the origin's precision
    wdt = torch.float64 if origin.dtype == np.float64 else torch.float32
    origin_t = torch.as_tensor(origin, device=dev).to(wdt)
    hi_ij = torch.tensor([W - 1, H - 1], device=dev)

    def cell_id(xy):
        ij = torch.floor((xy.to(wdt) - origin_t) / res).to(torch.int32).to(torch.int64)
        ij = torch.minimum(torch.clamp(ij, min=0), hi_ij)
        return ij[..., 0] * H + ij[..., 1]

    hits = torch.zeros((W * H,), dtype=torch.int32, device=dev)
    visits = torch.zeros((W * H,), dtype=torch.int32, device=dev)
    half = np.float32(0.5 * res)
    for p, org in zip(pts_all, scan_origins):
        if len(p) == 0:
            continue
        pj = torch.as_tensor(np.ascontiguousarray(p[:, [0, 2]]).astype(np.float32), device=dev)
        ids = cell_id(pj)
        ones = torch.ones(ids.shape[0], dtype=torch.int32, device=dev)
        hits.index_add_(0, ids, ones)
        visits.index_add_(0, ids, ones)
        if params.count_free:
            o = torch.as_tensor(np.asarray(org)[[0, 2]].astype(np.float32), device=dev)
            ray = pj - o
            rlen = torch.sqrt(fma_f32(ray[:, 1], ray[:, 1], ray[:, 0] * ray[:, 0]).double()).float()
            kmax = int(np.ceil(float(rlen.max()) / (0.5 * res))) + 1
            ts = torch.arange(1, kmax + 1, dtype=torch.float32, device=dev) * half
            rl = torch.clamp(rlen, min=1e-9)
            tend = ((rlen - np.float32(res)) / rl)[:, None]
            rows = max(1, tile // kmax)
            for a in range(0, len(p), rows):
                b = min(a + rows, len(p))
                t = torch.minimum(ts[None, :] / rl[a:b, None], tend[a:b])
                t = torch.clamp(t, min=0.0)
                samples = o + ray[a:b, None, :] * t[:, :, None]
                sids = cell_id(samples).reshape(-1)
                visits.index_add_(0, sids, torch.ones(sids.shape[0], dtype=torch.int32, device=dev))
                metrics.count(RAY_TILES)
    return OccupancyGrid(
        origin=np.asarray(origin),
        resolution=res,
        hits=hits.cpu().numpy().reshape(W, H),
        visits=visits.cpu().numpy().reshape(W, H),
    )


def write_gnuplot(grid: "OccupancyGrid", path: str,
                  threshold: float = 0.5) -> int:
    """Occupied cell centers as 'x z' lines for gnuplot (ref
    gridWriter.cc gnuplotWriter::write).  Returns cell count."""
    occ = grid.occupancy
    ys, xs = np.nonzero(occ.T >= threshold)  # transpose: rows = z
    n = 0
    with open(path, "w") as f:
        for x, z in zip(xs, ys):
            wx = grid.origin[0] + (x + 0.5) * grid.resolution
            wz = grid.origin[1] + (z + 0.5) * grid.resolution
            f.write(f"{wx} {wz}\n")
            n += 1
    return n


def write_world(grid: "OccupancyGrid", path: str) -> None:
    """World-map text format: header (bounds, resolution) + per-cell
    occupancy percentage rows (ref gridWriter.cc worldWriter)."""
    occ = grid.occupancy
    W, H = occ.shape
    with open(path, "w") as f:
        f.write(
            f"{grid.origin[0]} {grid.origin[0] + W * grid.resolution} "
            f"{grid.origin[1]} {grid.origin[1] + H * grid.resolution} "
            f"{grid.resolution}\n"
        )
        for j in range(H):
            f.write(
                " ".join(
                    "-1" if occ[i, j] < 0 else f"{int(occ[i, j] * 100)}"
                    for i in range(W)
                )
                + "\n"
            )


def extract_gridlines(
    grid: "OccupancyGrid",
    threshold: float = 0.5,
    min_length: float = 2.0,
    n_theta: int = 180,
    n_rho: int = 256,
    min_votes: int = 8,
    max_lines: int = 32,
    device=None,
):
    """Line segments from an occupancy grid — the ``gridlines`` tool
    (ref src/grid/gridlines.cc: Hough transform over solid cells, then
    segment extraction).  Every solid cell's rho against every direction
    is the f32 ``jnp.dot`` of the JAX package (fma(y, sin, x·cos)); each
    round's vote is one bincount on ``device`` (None: the first CUDA
    card); the segment walk stays on the host.  Returns [(p0 [2], p1
    [2])] world-coordinate segments with length >= min_length cells."""
    if device is None:
        from .. import default_device

        device = default_device()
    dev = torch.device(device)
    occ = grid.occupancy
    xs, zs = np.nonzero(occ >= threshold)
    if len(xs) == 0:
        return []
    pts = np.stack(
        [
            grid.origin[0] + (xs + 0.5) * grid.resolution,
            grid.origin[1] + (zs + 0.5) * grid.resolution,
        ],
        axis=1,
    )
    thetas = np.linspace(0, np.pi, n_theta, endpoint=False)
    dirs = np.stack([np.cos(thetas), np.sin(thetas)], axis=1)
    p32 = torch.as_tensor(pts.astype(np.float32), device=dev)
    d32 = torch.as_tensor(dirs.T.astype(np.float32), device=dev)
    rho = fma_f32(p32[:, 1:2], d32[1][None, :], p32[:, 0:1] * d32[0][None, :])
    rho = rho.cpu().numpy()  # [N, n_theta] f32
    rmin, rmax = rho.min(), rho.max()
    bw = max((rmax - rmin) / n_rho, 1e-6)
    bins = np.clip(((rho - rmin) / bw).astype(int), 0, n_rho - 1)
    flat = torch.as_tensor(np.arange(n_theta)[None, :] * n_rho + bins, device=dev)
    segments = []
    used = np.zeros(len(pts), bool)
    for _ in range(max_lines):
        alive = ~used
        acc = torch.bincount(
            flat[torch.as_tensor(alive, device=dev)].reshape(-1), minlength=n_theta * n_rho
        )
        best = int(torch.argmax(acc))
        tI, rI = divmod(best, n_rho)
        if int(acc[best]) < min_votes:
            break
        on_line = alive & (np.abs(bins[:, tI] - rI) <= 1)
        if on_line.sum() < min_votes:
            break
        sel = pts[on_line]
        d = dirs[tI]
        t = sel @ np.array([-d[1], d[0]])  # position along the line
        order = np.argsort(t)
        sel, t = sel[order], t[order]
        # split at gaps > 3 cells (segment extraction, gridlines.cc)
        gap = grid.resolution * 3.0
        start = 0
        for k in range(1, len(t) + 1):
            if k == len(t) or t[k] - t[k - 1] > gap:
                if (
                    t[k - 1] - t[start]
                    >= min_length * grid.resolution
                ):
                    segments.append((sel[start].copy(), sel[k - 1].copy()))
                start = k
        used |= on_line
    return segments
