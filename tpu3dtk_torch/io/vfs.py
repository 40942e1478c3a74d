"""Zip-transparent filesystem helpers.

The reference reads scan directories straight out of zip archives with
paths like ``.../normals.zip/normals`` (testing/scanio/zipreader.cc:27-29,
boost-iostreams based).  Here the same path convention is handled by a
tiny VFS layer: any path component ending in ``.zip`` switches resolution
into the archive.  All scandir I/O goes through these helpers so every
format reader gains archive support for free.
"""

from __future__ import annotations

import io
import os
import zipfile
from functools import lru_cache

__all__ = ["split_zip", "vlistdir", "vexists", "vopen"]


def split_zip(path: str) -> tuple[str, str] | None:
    """If `path` crosses into a .zip archive, return (zip_path, inner);
    otherwise None.  ``a/b.zip/c/d`` -> (``a/b.zip``, ``c/d``)."""
    parts = path.replace(os.sep, "/").split("/")
    for i, part in enumerate(parts):
        if part.lower().endswith(".zip"):
            zp = "/".join(parts[: i + 1])
            if os.path.isfile(zp):
                return zp, "/".join(parts[i + 1 :])
    return None


@lru_cache(maxsize=8)
def _open_zip(zip_path: str) -> zipfile.ZipFile:
    return zipfile.ZipFile(zip_path, "r")


def _zip_names(zip_path: str) -> list[str]:
    return _open_zip(zip_path).namelist()


def vlistdir(path: str) -> list[str]:
    """os.listdir that sees inside zip archives."""
    hit = split_zip(path)
    if hit is None:
        return sorted(os.listdir(path))
    zp, inner = hit
    prefix = inner.rstrip("/") + "/" if inner else ""
    out = set()
    for name in _zip_names(zp):
        if not name.startswith(prefix):
            continue
        rest = name[len(prefix) :]
        if not rest:
            continue
        out.add(rest.split("/", 1)[0])
    return sorted(out)


def vexists(path: str) -> bool:
    hit = split_zip(path)
    if hit is None:
        return os.path.exists(path)
    zp, inner = hit
    names = _zip_names(zp)
    return inner in names or any(n.startswith(inner.rstrip("/") + "/") for n in names)


def vopen(path: str, mode: str = "rb"):
    """open() that reads members of zip archives (read-only there)."""
    hit = split_zip(path)
    if hit is None:
        return open(path, mode)
    if "w" in mode or "a" in mode or "+" in mode:
        raise IOError(f"cannot write inside zip archive: {path}")
    zp, inner = hit
    data = _open_zip(zp).read(inner)
    return io.BytesIO(data)
