"""Scan directory reading: the equivalent of ``Scan::openDirectory`` +
``ScanIO::readDirectory/readPose/readScan`` (ref include/scanio/scan_io.h:30-119,
src/slam6d/basicScan.cc:39-124).

Host-side, numpy-backed.  Point filters mirror the reference's
``PointFilter`` checker chain (include/slam6d/pointfilter.h:27-83):
range/height/custom predicates applied at load time.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Iterator

import numpy as np

from .formats import FormatSpec, get_format, parse_scan_text
from .vfs import split_zip, vexists, vlistdir, vopen

__all__ = ["PointFilter", "RawScan", "read_scan_dir", "read_pose_file", "list_identifiers"]


@dataclasses.dataclass
class PointFilter:
    """Load-time point filter chain (ref pointfilter.h:27-83).

    All distances in cm, matching the reference flag semantics:
    ``-m/--max`` range_max, ``-M/--min`` range_min, height via custom.
    """

    range_max: float | None = None  # max distance from scanner origin
    range_min: float | None = None
    height_top: float | None = None  # y axis (uos frame is y-up)
    height_bottom: float | None = None
    scale: float = 1.0  # applied to xyz before filtering
    # custom predicate DSL (ref pointfilter.cc:273-420 CheckerCustom):
    # "{mode};{nParams}[;p1][;p2].../{modeB};..." — a point is REMOVED
    # when any sub-filter fires.  Modes: 0/1/2 cuboid keeps inside,
    # 10/11 keep outside, 20 keep between two cuboids, 21/22 sphere
    # keep inside/outside.
    custom: str | None = None

    def apply(self, xyz: np.ndarray) -> np.ndarray:
        """Return boolean keep-mask for [N,3] points (local frame)."""
        keep = np.ones(len(xyz), dtype=bool)
        if self.range_max is not None:
            keep &= np.einsum("ij,ij->i", xyz, xyz) <= self.range_max**2
        if self.range_min is not None:
            keep &= np.einsum("ij,ij->i", xyz, xyz) >= self.range_min**2
        if self.height_top is not None:
            keep &= xyz[:, 1] <= self.height_top
        if self.height_bottom is not None:
            keep &= xyz[:, 1] >= self.height_bottom
        if self.custom:
            keep &= ~custom_filter_mask(xyz, self.custom)
        return keep


def custom_filter_mask(xyz: np.ndarray, spec: str) -> np.ndarray:
    """Vectorized CheckerCustom (pointfilter.cc:296-420): True where a
    point is REMOVED (any sub-filter fires).  Sub-filters are separated
    by '/', each '{mode};{nParams}[;params...]'."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    removed = np.zeros(len(xyz), bool)
    for part in spec.split("/"):
        fields = part.split(";")
        mode = int(fields[0])
        n = int(fields[1])
        p = [float(v) for v in fields[2 : 2 + n]]
        if mode == 0:  # symmetric cuboid: keep inside
            fire = (
                (np.abs(x) > p[0]) | (np.abs(y) > p[1]) | (np.abs(z) > p[2])
            )
        elif mode == 1:  # asymmetric cuboid: keep inside
            fire = (
                (x < p[0]) | (x > p[1]) | (y < p[2]) | (y > p[3])
                | (z < p[4]) | (z > p[5])
            )
        elif mode == 2:  # cuboid keep-inside, only within maxRange
            outside = (
                (x < p[0]) | (x > p[1]) | (y < p[2]) | (y > p[3])
                | (z < p[4]) | (z > p[5])
            )
            fire = outside & (x * x + y * y + z * z < p[6] * p[6])
        elif mode == 10:  # symmetric cuboid: keep outside
            fire = (
                (np.abs(x) < p[0]) & (np.abs(y) < p[1]) & (np.abs(z) < p[2])
            )
        elif mode == 11:  # asymmetric cuboid: keep outside
            fire = (
                (x > p[0]) & (x < p[1]) & (y > p[2]) & (y < p[3])
                & (z > p[4]) & (z < p[5])
            )
        elif mode == 20:  # keep between outer and inner cuboid
            in_outer = (
                (x > p[0]) & (x < p[1]) & (y > p[2]) & (y < p[3])
                & (z > p[4]) & (z < p[5])
            )
            out_inner = (
                (x < p[6]) | (x > p[7]) | (y < p[8]) | (y > p[9])
                | (z < p[10]) | (z > p[11])
            )
            fire = in_outer & out_inner
        elif mode == 21:  # sphere: keep inside
            d2 = (x - p[0]) ** 2 + (y - p[1]) ** 2 + (z - p[2]) ** 2
            fire = d2 > p[3] * p[3]
        elif mode == 22:  # sphere: keep outside
            d2 = (x - p[0]) ** 2 + (y - p[1]) ** 2 + (z - p[2]) ** 2
            fire = d2 < p[3] * p[3]
        else:
            raise ValueError(f"unknown custom filter mode {mode}")
        removed |= fire
    return removed


def parse_range_set(spec: str) -> list[tuple[int, int, int]]:
    """The scan_settings range DSL (include/slam6d/scan_settings.h:
    146-716 / parsers/range_set_parser.h): comma-separated ranges
    'a:b' (inclusive), 'a:step:b', bare 'a', '$' = unlimited end.
    Returns [(start, end, step)] with end = -1 for unlimited."""
    ranges = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        toks = part.split(":")
        if len(toks) == 1:
            a = int(toks[0])
            ranges.append((a, a, 1))
        elif len(toks) == 2:
            a = int(toks[0])
            b = -1 if toks[1] in ("$", "") else int(toks[1])
            ranges.append((a, b, 1))
        elif len(toks) == 3:
            a = int(toks[0])
            step = int(toks[1])
            b = -1 if toks[2] in ("$", "") else int(toks[2])
            ranges.append((a, b, step))
        else:
            raise ValueError(f"bad range: {part!r}")
    return ranges


def expand_range_set(spec: str, available: list[int]) -> list[int]:
    """Apply a range-set spec to the available scan numbers; returns
    the selected numbers sorted ascending."""
    out: set[int] = set()
    for a, b, step in parse_range_set(spec):
        for n in available:
            if n < a or (b >= 0 and n > b):
                continue
            if (n - a) % step:
                continue
            out.add(n)
    return sorted(out)


@dataclasses.dataclass
class RawScan:
    """One scan as read from disk: local-frame points + channels + pose."""

    identifier: str
    channels: dict[str, np.ndarray]  # "xyz": [N,3] f64 local frame, ...
    pose_pos: np.ndarray  # [3] from .pose (cm)
    pose_theta: np.ndarray  # [3] radians
    directory: str = ""

    @property
    def xyz(self) -> np.ndarray:
        return self.channels["xyz"]

    @property
    def size(self) -> int:
        return len(self.channels["xyz"])


def read_pose_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a .pose file: line1 = x y z (cm), line2 = θx θy θz (degrees).
    Returns (pos, theta_radians).  Ref: scanio helper readPose."""
    with vopen(path, "rb") as f:
        vals = np.loadtxt(f, dtype=np.float64).reshape(-1)
    if vals.size < 6:
        raise ValueError(f"pose file {path} has {vals.size} < 6 values")
    pos = vals[:3]
    theta = np.deg2rad(vals[3:6])
    return pos, theta


def list_identifiers(directory: str, spec: FormatSpec, start: int = 0, end: int = -1) -> list[str]:
    """Find scan identifiers (zero-padded numeric suffixes) present in the
    directory, honoring [start, end] (ref readDirectory semantics; alt
    suffixes mirror the laz reader's .laz-then-.las fallback,
    scan_io_laz.cc:51-52)."""
    suffixes = (spec.data_suffix,) + spec.alt_suffixes
    pats = [
        re.compile(re.escape(spec.data_prefix) + r"(\d+)" + re.escape(s) + r"$")
        for s in suffixes
    ]
    ids: set[str] = set()
    for fn in vlistdir(directory):
        for pat in pats:
            m = pat.match(fn)
            if m:
                num = int(m.group(1))
                if num >= start and (end < 0 or num <= end):
                    ids.add(m.group(1))
                break
    return sorted(ids, key=int)


def _load_data_file(path: str, spec: FormatSpec) -> np.ndarray:
    """Whitespace table loader.  ``numpy.loadtxt`` (a C tokenizer) is the
    first path; the native C++ parser (``tpu3dtk_torch.native``, built
    at first use) takes the files numpy rejects (ragged rows, stray
    tokens), as in the JAX package.  A file inside a zip archive has no
    real path for the parser, so numpy's error stands there."""
    try:
        with vopen(path, "rb") as f:
            for _ in range(spec.skip_header_lines):
                f.readline()
            return np.loadtxt(f, dtype=np.float64, ndmin=2)
    except ValueError:
        if split_zip(path) is not None:
            raise  # the native parser wants a real file path
        from .. import native

        return native.parse_table(path, spec.skip_header_lines)


def _read_pose_riegl(path: str) -> tuple[np.ndarray, np.ndarray]:
    """RIEGL .dat pose: 16 doubles, a row-major 4x4 in the RIEGL frame
    (translation at slots 3/7/11), remapped into a column-major uos-frame
    matrix exactly as scan_io_riegl_txt.cc:73-98."""
    from ..core import math3d

    with vopen(path, "rb") as f:
        m = np.loadtxt(f, dtype=np.float64).reshape(-1)
    if m.size < 16:
        raise ValueError(f"riegl pose file {path} has {m.size} < 16 values")
    t = np.array(
        [
            m[5], -m[9], -m[1], -m[13],
            -m[6], m[10], m[2], m[14],
            -m[4], m[8], m[0], m[12],
            -m[7], m[11], m[3], m[15],
        ]
    )
    T = math3d.from_colmajor16(t)
    theta, pos = math3d.matrix4_to_euler(T)
    return 100.0 * np.asarray(pos), np.asarray(theta)


def _read_pose_ks(path: str) -> tuple[np.ndarray, np.ndarray]:
    """ks pose: standard .pose values, then CAD-map axis remap
    [x,y,z] -> [-z,y,x] and m -> cm (scan_io_ks.cc:30-41)."""
    pos, theta = read_pose_file(path)
    pos = np.array([-pos[2], pos[1], pos[0]]) * 100.0
    return pos, theta


_POSE_READERS = {
    "pose": read_pose_file,
    "riegl": _read_pose_riegl,
    "ks": _read_pose_ks,
}


def read_scan(
    directory: str,
    identifier: str,
    spec: FormatSpec,
    point_filter: PointFilter | None = None,
) -> RawScan:
    data_path = os.path.join(
        directory, f"{spec.data_prefix}{identifier}{spec.data_suffix}"
    )
    if not vexists(data_path):
        for alt in spec.alt_suffixes:
            cand = os.path.join(directory, f"{spec.data_prefix}{identifier}{alt}")
            if vexists(cand):
                data_path = cand
                break
    pose_path = os.path.join(
        directory, f"{spec.pose_prefix}{identifier}{spec.pose_suffix}"
    )
    if spec.binary == "las":
        from .las import read_las

        channels = read_las(data_path)
        channels["xyz"] = spec.transform(channels["xyz"])
    elif spec.binary == "velodyne":
        from .velodyne import read_velodyne

        channels = read_velodyne(data_path)
        channels["xyz"] = spec.transform(channels["xyz"])
    elif spec.binary == "e57":
        from .e57 import read_e57

        channels = {
            k: v for k, v in read_e57(data_path).items()
            if not k.startswith("pose_")
        }
        channels["xyz"] = spec.transform(channels["xyz"])
    else:
        raw = _load_data_file(data_path, spec)
        channels = parse_scan_text(raw, spec)
    if vexists(pose_path):
        pos, theta = _POSE_READERS[spec.pose_reader](pose_path)
    else:
        pos = np.zeros(3)
        theta = np.zeros(3)
    if point_filter is not None:
        if point_filter.scale != 1.0:
            channels["xyz"] = channels["xyz"] * point_filter.scale
        keep = point_filter.apply(channels["xyz"])
        channels = {
            k: (v[keep] if len(v) == len(keep) else v) for k, v in channels.items()
        }
    return RawScan(
        identifier=identifier,
        channels=channels,
        pose_pos=pos,
        pose_theta=theta,
        directory=directory,
    )


def read_scan_dir(
    directory: str,
    format: str = "uos",
    start: int = 0,
    end: int = -1,
    point_filter: PointFilter | None = None,
) -> Iterator[RawScan]:
    """Lazily yield scans from a directory (ref Scan::openDirectory,
    scan.h:157; points are read eagerly per scan, poses with them)."""
    spec = get_format(format)
    for ident in list_identifiers(directory, spec, start, end):
        yield read_scan(directory, ident, spec, point_filter)
