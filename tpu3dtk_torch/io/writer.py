"""Point/pose export — equivalent of the reference's writer + exportPoints
(ref src/scanio/writer.cc, src/slam6d/exportPoints.cc)."""

from __future__ import annotations

import os

import numpy as np


def write_uos(path: str, xyz: np.ndarray, reflectance: np.ndarray | None = None) -> None:
    """Write points in uos / uosr layout (ref writer.cc write_uos)."""
    xyz = np.asarray(xyz)
    if reflectance is not None:
        data = np.column_stack([xyz, np.asarray(reflectance)])
    else:
        data = xyz
    np.savetxt(path, data, fmt="%.10g")


def write_pose(path: str, pos: np.ndarray, theta_rad: np.ndarray) -> None:
    """Write a .pose file: position line + Euler degrees line."""
    with open(path, "w") as f:
        f.write(" ".join(repr(float(v)) for v in np.asarray(pos)) + "\n")
        f.write(
            " ".join(repr(float(np.rad2deg(v))) for v in np.asarray(theta_rad)) + "\n"
        )


def export_points(
    scans,
    out_dir: str,
    *,
    reduced: bool = False,
    per_scan: bool = False,
) -> None:
    """Export registered scans in global frame (ref exportPoints.cc).

    scans: iterable of objects with .points_global() / .reduced_global()
    and .identifier.  If per_scan, writes scanXXX.3d + .pose per scan,
    else one points.txt.
    """
    os.makedirs(out_dir, exist_ok=True)
    if not per_scan:
        chunks = []
        for s in scans:
            pts = s.reduced_global() if reduced else s.points_global()
            chunks.append(np.asarray(pts))
        write_uos(os.path.join(out_dir, "points.txt"), np.concatenate(chunks, axis=0))
        return
    for s in scans:
        pts = s.reduced_global() if reduced else s.points_global()
        write_uos(os.path.join(out_dir, f"scan{s.identifier}.3d"), np.asarray(pts))
        write_pose(
            os.path.join(out_dir, f"scan{s.identifier}.pose"),
            np.asarray(s.rPos),
            np.asarray(s.rPosTheta),
        )
