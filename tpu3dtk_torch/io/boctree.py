"""Show-compatible ``.oct`` octree serialization.

Byte-compatible with the reference's ``BOctTree<float>::serialize`` /
``deserialize`` (include/slam6d/Boctree.h:449-560, 902-926), the format
behind ``slam6D --saveOct`` / ``show --loadOct`` and the autoOct cache
(src/slam6d/basicScan.cc:775-845):

    magic   "XT"
    uint32  PointType flags (USE_NONE=0 → xyz only)
    T[5]    voxelSize, center.xyz, size        (T = float32 for show)
    int32   POINTDIM
    T[2*POINTDIM]  mins, maxs
    node    := uint8 valid, uint8 leaf,
               then per set bit i of valid (ascending):
                 leaf bit set  → uint32 n, T[n*POINTDIM] coords
                 leaf bit unset→ node (recursive)

Octant convention (Boctree.h childIndex:1353): bit0 = x>cx, bit1 = y>cy,
bit2 = z>cz; child centers at parent ± size/2 with child half-size
size/2 (childcenter, Boctree.h:612-655); a child becomes a leaf when
its half-size <= voxelSize (branch, Boctree.h:1164-1172); the root cube
half-size is max extent/2 + 1.0 (Boctree.h:249-255).

This is deliberately a HOST-side codec (pure numpy + struct): it exists
for interop — reference ``show`` can load our caches and we can ingest
octrees the reference toolchain produced — not for the compute path.
The port's copy of ``tpu3dtk.io.boctree``: it writes the same bytes for
the same points and voxel size (tests/test_torch_boctree.py).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["write_oct", "read_oct", "oct_header"]

# PointType flags (src/slam6d/point_type.cc:173-175)
USE_NONE = 0
USE_REFLECTANCE = 1


def _node_bytes(out: list, pts: np.ndarray, center: np.ndarray,
                size: float, voxel: float, dtype) -> None:
    """Append one serialized node (and its subtree) to ``out``."""
    cx, cy, cz = center
    idx = (
        (pts[:, 0] > cx).astype(np.uint8)
        | ((pts[:, 1] > cy).astype(np.uint8) << 1)
        | ((pts[:, 2] > cz).astype(np.uint8) << 2)
    )
    half = size / 2.0
    groups = [pts[idx == i] for i in range(8)]
    valid = 0
    leaf = 0
    for i, g in enumerate(groups):
        if len(g):
            valid |= 1 << i
            if half <= voxel:
                leaf |= 1 << i
    out.append(struct.pack("<BB", valid, leaf))
    offs = np.array(
        [[(1 if i & 1 else -1), (1 if i & 2 else -1), (1 if i & 4 else -1)]
         for i in range(8)], np.float64,
    )
    for i, g in enumerate(groups):
        if not len(g):
            continue
        ccenter = center + half * offs[i]
        if leaf & (1 << i):
            out.append(struct.pack("<I", len(g)))
            out.append(np.ascontiguousarray(g, dtype).tobytes())
        else:
            _node_bytes(out, g, ccenter, half, voxel, dtype)


def write_oct(path: str, points: np.ndarray, voxel_size: float,
              dtype=np.float32) -> None:
    """Serialize ``points`` [N,3] into a show-compatible .oct file."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if len(pts) == 0:
        mins = maxs = np.zeros(3)
    else:
        mins = pts.min(axis=0)
        maxs = pts.max(axis=0)
    center = 0.5 * (mins + maxs)
    size = float(np.max(0.5 * (maxs - mins))) + 1.0  # Boctree.h:253-255
    out: list[bytes] = [b"XT", struct.pack("<I", USE_NONE)]
    out.append(np.asarray([voxel_size, *center, size], dtype).tobytes())
    out.append(struct.pack("<i", 3))
    out.append(np.asarray(mins, dtype).tobytes())
    out.append(np.asarray(maxs, dtype).tobytes())
    _node_bytes(out, pts, center, size, float(voxel_size), dtype)
    with open(path, "wb") as f:
        f.write(b"".join(out))


def oct_header(path: str, dtype=np.float32):
    """Parse just the .oct header.  Returns dict(voxel, center, size,
    pointdim, mins, maxs, types, offset)."""
    tsize = np.dtype(dtype).itemsize
    with open(path, "rb") as f:
        if f.read(2) != b"XT":
            raise ValueError(f"{path}: not an octree file (missing XT)")
        (types,) = struct.unpack("<I", f.read(4))
        hdr = np.frombuffer(f.read(5 * tsize), dtype)
        (pointdim,) = struct.unpack("<i", f.read(4))
        mins = np.frombuffer(f.read(pointdim * tsize), dtype)
        maxs = np.frombuffer(f.read(pointdim * tsize), dtype)
        offset = f.tell()
    return dict(
        voxel=float(hdr[0]), center=np.asarray(hdr[1:4], np.float64),
        size=float(hdr[4]), pointdim=int(pointdim),
        mins=np.asarray(mins, np.float64), maxs=np.asarray(maxs, np.float64),
        types=int(types), offset=offset,
    )


def read_oct(path: str, dtype=np.float32) -> np.ndarray:
    """Deserialize a .oct file (ours or the reference toolchain's) into
    an [N, POINTDIM] float64 array (the static BOctTree::deserialize
    overload that collects all leaf points, Boctree.h:492-522)."""
    hdr = oct_header(path, dtype)
    pointdim = hdr["pointdim"]
    tsize = np.dtype(dtype).itemsize
    with open(path, "rb") as f:
        buf = f.read()
    chunks: list[np.ndarray] = []

    # leaf point blocks and child nodes are interleaved inline in
    # ascending valid-bit order; recursion depth = octree depth (< 40)
    def parse(pos: int) -> int:
        valid, leaf = struct.unpack_from("<BB", buf, pos)
        pos += 2
        for i in range(8):
            if not (valid & (1 << i)):
                continue
            if leaf & (1 << i):
                (n,) = struct.unpack_from("<I", buf, pos)
                pos += 4
                arr = np.frombuffer(
                    buf, dtype, count=n * pointdim, offset=pos
                ).reshape(n, pointdim)
                chunks.append(arr.astype(np.float64))
                pos += n * pointdim * tsize
            else:
                pos = parse(pos)
        return pos

    parse(hdr["offset"])
    if not chunks:
        return np.zeros((0, pointdim))
    return np.concatenate(chunks, axis=0)
