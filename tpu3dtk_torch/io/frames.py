"""`.frames` pose-log persistence — the reference's checkpoint/animation
format (ref src/slam6d/basicScan.cc:902-945 saveFrames/readFrames; format
documented in doc/high_level_doc/documentation.tex:482-492).

Each line: 16 doubles (OpenGL column-major 4x4) + integer AlgoType.
The final line of a scan's file is its final registered pose; `show`
replays all lines as animation; ``--continue`` resumes from the last
line.  We keep the format bit-identical for interop with the reference
viewer and evaluation tools.
"""

from __future__ import annotations

import enum
import os

import numpy as np


class AlgoType(enum.IntEnum):
    """ref include/slam6d/scan.h:126."""

    INVALID = 0
    ICP = 1
    ICPINACTIVE = 2
    LUM = 3
    ELCH = 4


def frames_path(directory: str, identifier: str, prefix: str = "scan") -> str:
    return os.path.join(directory, f"{prefix}{identifier}.frames")


def write_frames(
    path: str, mats: np.ndarray, types: np.ndarray | list[int]
) -> None:
    """Write a .frames file.

    mats: [K, 4, 4] row-standard pose matrices (converted to column-major
    on disk); types: [K] AlgoType ints.
    """
    mats = np.asarray(mats, dtype=np.float64)
    types = np.asarray(types, dtype=np.int64)
    colmajor = mats.transpose(0, 2, 1).reshape(len(mats), 16)
    with open(path, "w") as f:
        for row, t in zip(colmajor, types):
            f.write(" ".join(repr(float(v)) for v in row))
            f.write(f" {int(t)}\n")


def read_frames(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a .frames file -> (mats [K,4,4] standard layout, types [K])."""
    data = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if data.shape[1] != 17:
        raise ValueError(f"{path}: expected 17 columns, got {data.shape[1]}")
    mats = data[:, :16].reshape(-1, 4, 4).transpose(0, 2, 1)
    types = data[:, 16].astype(np.int64)
    return mats, types


def final_pose(path: str) -> np.ndarray:
    """Last pose in a .frames file (the registered result / resume point)."""
    mats, _ = read_frames(path)
    return mats[-1]
