"""Linear (pointer-free) octree — the port's ``BOctTree``
(ref include/slam6d/Boctree.h:78-492: compressed bitoct nodes serving as
point-reduction engine, serializable display structure and NN search
structure).

Design: instead of child-pointer records, the tree is *implicit* in
sorted Morton codes — an array program.  Each point gets an interleaved
x/y/z code at max depth; unique code prefixes at depth d are exactly
the occupied nodes at that level.  This supports the same operations:

- leaf representatives (center / random / mean) == GetOctTreeCenter /
  GetOctTreeRandom / GetOctTreeAvg (Boctree.h:435-492)
- level-of-detail queries: unique prefixes at a shallower depth
  (the viewer's LOD walk, show_Boctree.h:504-561)
- serialize/deserialize: compact header + leaf codes + per-leaf counts
  + packed points (our own format, versioned; the reference's .oct
  binary layout is pointer-arithmetic specific)

Construction is O(N log N) (sort) and fully vectorized.

The port's copy of ``tpu3dtk.ops.octree``, host numpy like it: the same
trees and the same serialized bytes (tests/test_torch_octree.py).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

__all__ = ["LinearOctree", "build_octree"]

_MAGIC = b"TPUOCT01"


@dataclasses.dataclass
class LinearOctree:
    origin: np.ndarray  # [3] cube corner
    size: float  # cube edge length
    depth: int  # leaf level (voxel edge = size / 2^depth)
    codes: np.ndarray  # [L] uint64 sorted unique leaf Morton codes
    counts: np.ndarray  # [L] points per leaf
    starts: np.ndarray  # [L] offsets into points_sorted
    points_sorted: np.ndarray  # [N, 3] points grouped by leaf

    # -- queries ----------------------------------------------------------
    @property
    def n_leaves(self) -> int:
        return len(self.codes)

    @property
    def voxel_edge(self) -> float:
        return self.size / (1 << self.depth)

    def _decode(self, codes: np.ndarray, depth: int) -> np.ndarray:
        """Morton codes -> integer cell coords at given depth."""
        shift = 3 * (self.depth - depth)
        c = codes >> shift
        x = _compact3(c >> 2)
        y = _compact3(c >> 1)
        z = _compact3(c)
        return np.stack([x, y, z], axis=1)

    def leaf_centers(self) -> np.ndarray:
        """One representative per leaf: voxel center (GetOctTreeCenter)."""
        ij = self._decode(self.codes, self.depth)
        edge = self.voxel_edge
        return self.origin + (ij + 0.5) * edge

    def leaf_means(self) -> np.ndarray:
        """Per-leaf centroid (GetOctTreeAvg)."""
        sums = np.add.reduceat(self.points_sorted, self.starts, axis=0)
        return sums / self.counts[:, None]

    def leaf_random(self, seed: int = 0) -> np.ndarray:
        """One random member point per leaf (GetOctTreeRandom)."""
        rng = np.random.default_rng(seed)
        offs = (rng.random(self.n_leaves) * self.counts).astype(np.int64)
        return self.points_sorted[self.starts + offs]

    def lod_centers(self, level: int) -> np.ndarray:
        """Occupied-node centers at a shallower level (viewer LOD)."""
        level = min(level, self.depth)
        shift = 3 * (self.depth - level)
        up = np.unique(self.codes >> shift)
        edge = self.size / (1 << level)
        x = _compact3(up >> 2)
        y = _compact3(up >> 1)
        z = _compact3(up)
        return self.origin + (np.stack([x, y, z], 1) + 0.5) * edge

    # -- serialization ----------------------------------------------------
    def serialize(self, path: str, with_points: bool = True) -> None:
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(
                struct.pack(
                    "<3ddiqB",
                    *self.origin,
                    self.size,
                    self.depth,
                    self.n_leaves,
                    1 if with_points else 0,
                )
            )
            f.write(self.codes.astype("<u8").tobytes())
            f.write(self.counts.astype("<u4").tobytes())
            if with_points:
                f.write(
                    struct.pack("<q", len(self.points_sorted))
                )
                f.write(self.points_sorted.astype("<f4").tobytes())

    @classmethod
    def deserialize(cls, path: str) -> "LinearOctree":
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a tpu3dtk octree file")
            ox, oy, oz, size, depth, nl, wp = struct.unpack(
                "<3ddiqB", f.read(8 * 4 + 4 + 8 + 1)
            )
            codes = np.frombuffer(f.read(8 * nl), dtype="<u8").copy()
            counts = np.frombuffer(f.read(4 * nl), dtype="<u4").astype(np.int64)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            if wp:
                (npts,) = struct.unpack("<q", f.read(8))
                pts = np.frombuffer(f.read(12 * npts), dtype="<f4").reshape(-1, 3).copy()
            else:
                pts = np.zeros((0, 3), np.float32)
        return cls(
            origin=np.array([ox, oy, oz]),
            size=size,
            depth=depth,
            codes=codes,
            counts=counts,
            starts=starts,
            points_sorted=pts.astype(np.float64),
        )


def _spread3(v: np.ndarray) -> np.ndarray:
    """Insert two zero bits between each bit (21-bit input)."""
    v = v.astype(np.uint64)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def _compact3(v: np.ndarray) -> np.ndarray:
    """Inverse of _spread3 (keep every third bit)."""
    v = v.astype(np.uint64) & np.uint64(0x1249249249249249)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return v.astype(np.int64)


def build_octree(points, voxel_size: float) -> LinearOctree:
    """Build from points with leaf voxels no larger than ``voxel_size``
    (the BOctTree(pts, voxelSize) contract, Boctree.h:219-290: cubic
    bounding box, power-of-two subdivision)."""
    pts = np.asarray(points, np.float64)
    lo = pts.min(0)
    hi = pts.max(0)
    size = float(max(hi - lo)) + 1e-9
    depth = max(1, int(np.ceil(np.log2(max(size / voxel_size, 1.0)))))
    depth = min(depth, 21)
    origin = lo
    edge = size / (1 << depth)
    ij = np.clip(
        np.floor((pts - origin) / edge).astype(np.int64), 0, (1 << depth) - 1
    )
    codes = (
        (_spread3(ij[:, 0]) << np.uint64(2))
        | (_spread3(ij[:, 1]) << np.uint64(1))
        | _spread3(ij[:, 2])
    )
    order = np.argsort(codes, kind="stable")
    codes_s = codes[order]
    pts_s = pts[order]
    uniq, starts, counts = np.unique(
        codes_s, return_index=True, return_counts=True
    )
    return LinearOctree(
        origin=origin,
        size=size,
        depth=depth,
        codes=uniq,
        counts=counts.astype(np.int64),
        starts=starts.astype(np.int64),
        points_sorted=pts_s,
    )
