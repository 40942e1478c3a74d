"""Floorplan extraction — the port of ``tpu3dtk.models.floorplan``: 2D
wall-line detection from registered clouds (ref src/floorplan/: project
to a horizontal slice, detect wall lines; SURVEY §2.6).

Pipeline: height-band slice -> occupancy image (``models.grid2d``, on
the device) -> probabilistic Hough lines (the port's
``ops.lines.hough_lines_p`` on the host, in place of
``cv2.HoughLinesP``) -> wall segments in world coordinates."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.lines import hough_lines_p
from .grid2d import Grid2DParams, make_occupancy_grid

__all__ = ["FloorplanParams", "WallSegment", "extract_floorplan"]


@dataclasses.dataclass(frozen=True)
class WallSegment:
    p0: np.ndarray  # [2] world (x, z) cm
    p1: np.ndarray

    @property
    def length(self) -> float:
        return float(np.linalg.norm(self.p1 - self.p0))


@dataclasses.dataclass
class FloorplanParams:
    resolution: float = 10.0  # cm per cell
    y_min: float = 50.0  # wall slice band
    y_max: float = 200.0
    min_votes: int = 20
    min_length: float = 80.0  # cm
    max_gap: float = 50.0  # cm


def extract_floorplan(
    scan_points: list[np.ndarray],
    scan_origins: list[np.ndarray],
    params: FloorplanParams | None = None,
    device=None,
) -> list[WallSegment]:
    """Wall segments of the scans' height band; the grid runs on
    ``device`` (None: the first CUDA card)."""
    params = params or FloorplanParams()
    grid = make_occupancy_grid(
        scan_points,
        scan_origins,
        Grid2DParams(
            resolution=params.resolution,
            y_min=params.y_min,
            y_max=params.y_max,
            count_free=False,
        ),
        device=device,
    )
    img = (grid.hits > 0).astype(np.uint8) * 255
    lines = hough_lines_p(
        img,
        rho=1,
        theta=np.pi / 180,
        threshold=params.min_votes,
        min_line_length=max(1, int(params.min_length / params.resolution)),
        max_line_gap=max(1, int(params.max_gap / params.resolution)),
    )
    out: list[WallSegment] = []
    for l in lines:
        # image coords: (col=j -> z axis of grid, row=i -> x axis)
        x0, y0, x1, y1 = map(float, l)
        # grid.hits is [W(x), H(z)] -> image rows = x, cols = z
        # the line finder sees img[row, col] = img[x_cell, z_cell] and
        # returns (col, row) pairs
        p0 = grid.origin + np.array([y0, x0]) * params.resolution
        p1 = grid.origin + np.array([y1, x1]) * params.resolution
        out.append(WallSegment(p0=p0, p1=p1))
    return out
