"""Triangle-mesh file output (the exportMesh role of the reference's
mesh module, src/mesh/poisson.cc exportMesh -> .obj, and vdb2mesh's
.ply output).

The port's copy of ``tpu3dtk.io.meshio`` (numpy only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["write_obj", "write_ply_mesh"]


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Wavefront OBJ (1-based face indices)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64) + 1
    with open(path, "w") as out:
        for p in v:
            out.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for t in f:
            out.write(f"f {t[0]} {t[1]} {t[2]}\n")


def write_ply_mesh(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY triangle mesh."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(v)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(f)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as out:
        out.write(header.encode())
        out.write(np.ascontiguousarray(v).tobytes())
        rows = np.zeros(len(f), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        rows["n"] = 3
        rows["idx"] = f
        out.write(rows.tobytes())
