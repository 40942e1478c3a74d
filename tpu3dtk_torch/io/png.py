"""Minimal dependency-free PNG I/O (RGB8) for the offscreen renderer.

The image path of the show counterpart must not pull GUI/toolkit
dependencies; PNG is zlib + CRC over filtered scanlines (RFC 2083).

The port's copy of ``tpu3dtk.io.png`` (numpy + zlib only).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_png", "read_png"]


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as an RGB8 PNG."""
    img = np.asarray(rgb, np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w, _ = img.shape
    raw = b"".join(
        b"\x00" + img[y].tobytes() for y in range(h)  # filter 0 per row
    )
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(raw, 6))
    out += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def read_png(path: str) -> np.ndarray:
    """Read an RGB8 PNG written by :func:`write_png` (filter-0 rows
    only — a codec for round-trip tests, not a general decoder)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack_from(">IIBB", payload)
            if depth != 8 or ctype != 2:
                raise ValueError("only RGB8 supported")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    img = np.zeros((h, w, 3), np.uint8)
    for y in range(h):
        row = raw[y * stride : (y + 1) * stride]
        if row[0] != 0:
            raise ValueError("only filter 0 supported")
        img[y] = np.frombuffer(row, np.uint8, w * 3, 1).reshape(w, 3)
    return img
