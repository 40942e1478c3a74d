"""Minimal pure-numpy ASPRS LAS reader (versions 1.0-1.4, point record
formats 0-10, uncompressed).

Plays the role of the reference's lastools-backed laz reader
(``src/scanio/scan_io_laz.cc:45-141``) without the 3rdparty library.
Compressed LAZ payloads are detected and rejected with a clear error
(the LAZ arithmetic coder is out of scope; convert with ``laszip`` first).

Returns xyz in the file's native frame (scale*raw + offset); the format
table applies the pts-style axis convention on top, matching
``scan_io_laz.cc:134-138`` ("las and laz are usually in pts coordinate
system", z negated).

The port's copy of ``tpu3dtk.io.las`` (numpy only; the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["read_las", "write_las"]

# point-record-format -> (record fields before extra bytes); xyz int32 and
# intensity uint16 are at fixed offsets 0..11 and 12..13 in every format
_MIN_RECORD_LEN = {0: 20, 1: 28, 2: 26, 3: 34, 4: 57, 5: 63, 6: 30, 7: 36, 8: 38, 9: 59, 10: 67}
# byte offset of the rgb triplet (3x uint16) within a record, if present
_RGB_OFFSET = {2: 20, 3: 28, 5: 28, 7: 30, 8: 30, 10: 30}


def read_las(path: str) -> dict[str, np.ndarray]:
    """Read one .las file -> {"xyz": [N,3] f64, "reflectance": [N] f32,
    optionally "rgb": [N,3] u8}.  Intensity maps to the reflectance
    channel (the reference routes LAS intensity there too).  Reads
    through the zip-transparent VFS (io/vfs.py)."""
    from .vfs import vopen

    with vopen(path, "rb") as f:
        header = f.read(375)
        if header[:4] != b"LASF":
            raise ValueError(f"{path}: not a LAS file (bad magic {header[:4]!r})")
        ver_major, ver_minor = header[24], header[25]
        offset_to_points = struct.unpack_from("<I", header, 96)[0]
        point_format = header[104]
        record_len = struct.unpack_from("<H", header, 105)[0]
        n_points = struct.unpack_from("<I", header, 107)[0]
        sx, sy, sz, ox, oy, oz = struct.unpack_from("<6d", header, 131)
        if ver_major == 1 and ver_minor >= 4 and n_points == 0:
            n_points = struct.unpack_from("<Q", header, 247)[0]
        if point_format & 0x80:
            raise ValueError(
                f"{path}: LAZ-compressed payload (point format "
                f"{point_format:#x}); decompress with laszip first"
            )
        fmt = point_format & 0x3F
        if fmt not in _MIN_RECORD_LEN:
            raise ValueError(f"{path}: unsupported LAS point format {fmt}")
        if record_len < _MIN_RECORD_LEN[fmt]:
            raise ValueError(
                f"{path}: record length {record_len} < minimum "
                f"{_MIN_RECORD_LEN[fmt]} for format {fmt}"
            )
        f.seek(offset_to_points)
        raw = np.frombuffer(f.read(n_points * record_len), dtype=np.uint8)
    if raw.size < n_points * record_len:
        raise ValueError(f"{path}: truncated point data")
    raw = raw.reshape(n_points, record_len)
    xyz_i = (
        raw[:, :12].reshape(-1).view(np.int32).reshape(n_points, 3).astype(np.float64)
    )
    xyz = xyz_i * np.array([sx, sy, sz]) + np.array([ox, oy, oz])
    intensity = (
        raw[:, 12:14].reshape(-1).view(np.uint16).astype(np.float32).reshape(n_points)
    )
    out = {"xyz": xyz, "reflectance": intensity}
    if fmt in _RGB_OFFSET:
        o = _RGB_OFFSET[fmt]
        rgb16 = raw[:, o : o + 6].reshape(-1).view(np.uint16).reshape(n_points, 3)
        out["rgb"] = (rgb16 // 257).astype(np.uint8)  # 16-bit -> 8-bit
    return out


def write_las(
    path: str,
    xyz: np.ndarray,
    intensity: np.ndarray | None = None,
    rgb: np.ndarray | None = None,
    scale: float = 1e-3,
) -> None:
    """Write a minimal LAS 1.2 file (point format 0 or 2 with rgb)."""
    xyz = np.asarray(xyz, dtype=np.float64)
    n = len(xyz)
    fmt = 2 if rgb is not None else 0
    record_len = _MIN_RECORD_LEN[fmt]
    offset = xyz.min(axis=0) if n else np.zeros(3)
    header = bytearray(227)
    header[:4] = b"LASF"
    header[24] = 1
    header[25] = 2
    struct.pack_into("<H", header, 94, 227)  # header size
    struct.pack_into("<I", header, 96, 227)  # offset to points
    header[104] = fmt
    struct.pack_into("<H", header, 105, record_len)
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<6d", header, 131, scale, scale, scale, *offset)
    mins = xyz.min(axis=0) if n else np.zeros(3)
    maxs = xyz.max(axis=0) if n else np.zeros(3)
    struct.pack_into(
        "<6d", header, 179, maxs[0], mins[0], maxs[1], mins[1], maxs[2], mins[2]
    )
    rec = np.zeros((n, record_len), dtype=np.uint8)
    xyz_i = np.round((xyz - offset) / scale).astype(np.int32)
    rec[:, :12] = xyz_i.view(np.uint8).reshape(n, 12)
    if intensity is not None:
        rec[:, 12:14] = (
            np.asarray(intensity, dtype=np.uint16).view(np.uint8).reshape(n, 2)
        )
    if rgb is not None:
        rgb16 = (np.asarray(rgb, dtype=np.uint16) * 257).astype(np.uint16)
        rec[:, 20:26] = rgb16.view(np.uint8).reshape(n, 6)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rec.tobytes())
