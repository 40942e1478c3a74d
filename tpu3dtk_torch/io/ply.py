"""Standalone PLY reader (ascii + binary_little_endian) — covers the
reference's rply-based ``scan_io_ply`` (src/scanio/scan_io_ply.cc,
3rdparty/rply) without a third-party C library.

Maps vertex properties to the framework's channel names: x/y/z -> xyz,
red/green/blue -> rgb, (intensity|scalar_intensity|reflectance) ->
reflectance, nx/ny/nz -> normal.

The port's copy of ``tpu3dtk.io.ply`` (numpy only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_ply"]

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read vertices of a PLY file -> channel dict {"xyz": [N,3], ...}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            parts = line.decode("ascii", "replace").split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "comment":
                continue
            elif parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property":
                if cur is None:
                    raise ValueError(f"{path}: property before element")
                if parts[1] == "list":
                    cur[2].append((parts[4], ("list", _DTYPES[parts[2]], _DTYPES[parts[3]])))
                else:
                    cur[2].append((parts[2], _DTYPES[parts[1]]))
            elif parts[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported format {fmt}")

        vertex_data = None
        for name, count, props in elements:
            if any(isinstance(d, tuple) for _, d in props):
                # list properties (faces): only supported after vertices
                if name == "vertex":
                    raise ValueError("list property in vertex element")
                break  # stop after reading vertices
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                arr = np.asarray(rows, dtype=np.float64)
                rec = {p: arr[:, i] for i, (p, _) in enumerate(props)}
            else:
                dt = np.dtype([(p, "<" + d) for p, d in props])
                buf = f.read(dt.itemsize * count)
                raw = np.frombuffer(buf, dtype=dt, count=count)
                rec = {p: raw[p].astype(np.float64) for p, _ in props}
            if name == "vertex":
                vertex_data = rec
                break  # vertices parsed; ignore the rest
    if vertex_data is None:
        raise ValueError(f"{path}: no vertex element")

    channels: dict[str, np.ndarray] = {}
    channels["xyz"] = np.stack(
        [vertex_data["x"], vertex_data["y"], vertex_data["z"]], axis=1
    )
    if all(k in vertex_data for k in ("red", "green", "blue")):
        channels["rgb"] = np.stack(
            [vertex_data["red"], vertex_data["green"], vertex_data["blue"]], axis=1
        ).astype(np.uint8)
    for k in ("intensity", "scalar_intensity", "reflectance"):
        if k in vertex_data:
            channels["reflectance"] = vertex_data[k]
            break
    if all(k in vertex_data for k in ("nx", "ny", "nz")):
        channels["normal"] = np.stack(
            [vertex_data["nx"], vertex_data["ny"], vertex_data["nz"]], axis=1
        )
    return channels
