"""Table-driven scan format registry.

Replaces the reference's dlopen plugin zoo (one shared library per format,
``src/scanio/scan_io.cc:45-95``) with declarative column specs, the same
way each plugin declares ``IODataType spec[]`` + a coordinate transform
(e.g. ``src/scanio/scan_io_uos.cc:27``, ``scan_io_uosr.cc:20``,
``helper.cc:63-72`` for the xyz->uos transform).

A format is: filename pattern (prefix/suffix for data and pose files),
column layout, and a linear coordinate transform into the internal "uos"
frame (left-handed, cm).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

# Column tags (subset of the reference's IODataType, io_types.h)
XYZ = "xyz"  # 3 columns
REFLECTANCE = "reflectance"
RGB = "rgb"  # 3 columns, uint8
TEMPERATURE = "temperature"
AMPLITUDE = "amplitude"
TYPE = "type"
DEVIATION = "deviation"
NORMAL = "normal"  # 3 columns
DUMMY = "dummy"  # skipped column

_NCOLS = {XYZ: 3, RGB: 3, NORMAL: 3, DUMMY: 1}


def _t_identity(xyz: np.ndarray) -> np.ndarray:
    return xyz


def _t_xyz(xyz: np.ndarray) -> np.ndarray:
    """Right-handed metres -> uos left-handed cm (ref helper.cc:63-72)."""
    out = np.empty_like(xyz)
    out[:, 0] = -100.0 * xyz[:, 1]
    out[:, 1] = 100.0 * xyz[:, 2]
    out[:, 2] = 100.0 * xyz[:, 0]
    return out


def _t_pts(xyz: np.ndarray) -> np.ndarray:
    """pts: negate z (ref helper.cc:74-80)."""
    out = xyz.copy()
    out[:, 2] = -out[:, 2]
    return out


def _t_rts(xyz: np.ndarray) -> np.ndarray:
    """rts: mm right-handed -> uos cm (ref helper.cc:48-61)."""
    out = np.empty_like(xyz)
    out[:, 0] = 0.1 * xyz[:, 1]
    out[:, 1] = -0.1 * xyz[:, 2]
    out[:, 2] = 0.1 * xyz[:, 0]
    return out


def _t_ks(xyz: np.ndarray) -> np.ndarray:
    """ks CAD-map frame: swap y/z, constant offset, m -> cm
    (ref helper.cc:15-35)."""
    out = np.empty_like(xyz)
    out[:, 0] = (xyz[:, 0] - 70000.0) * 100.0
    out[:, 1] = xyz[:, 2] * 100.0
    out[:, 2] = (xyz[:, 1] - 20000.0) * 100.0
    return out


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    name: str
    columns: tuple[str, ...]  # channel per column group
    transform: Callable[[np.ndarray], np.ndarray] = _t_identity
    data_prefix: str = "scan"
    data_suffix: str = ".3d"
    pose_prefix: str = "scan"
    pose_suffix: str = ".pose"
    skip_header_lines: int = 0
    pose_in_data_file: bool = False  # "old" style formats
    # pose file flavor: "pose" (x y z / θ in deg), "riegl" (4x4 col-major
    # matrix in .dat, remapped: scan_io_riegl_txt.cc:73-98), "ks" (pose with
    # CAD-map axis remap + m->cm: scan_io_ks.cc:30-41)
    pose_reader: str = "pose"
    # binary data loader name ("las") for non-ASCII formats; "" = ASCII table
    binary: str = ""
    alt_suffixes: tuple[str, ...] = ()  # fallback data suffixes (laz -> las)
    invalid_type_mask: int = 0  # drop points with (type & mask) != 0 (rts)

    @property
    def ncols(self) -> int:
        return sum(_NCOLS.get(c, 1) for c in self.columns)


FORMATS: dict[str, FormatSpec] = {}


def register(spec: FormatSpec) -> FormatSpec:
    FORMATS[spec.name] = spec
    return spec


# ref scan_io_uos.cc:22-28
register(FormatSpec("uos", (XYZ,)))
# ref scan_io_uosr.cc:20
register(FormatSpec("uosr", (XYZ, REFLECTANCE)))
# ref scan_io_uos_rgb.cc:20-21
register(FormatSpec("uos_rgb", (XYZ, RGB)))
# ref scan_io_uos_rrgbt.cc:22-24 (refl, rgb, temperature)
register(FormatSpec("uos_rrgbt", (XYZ, REFLECTANCE, RGB, TEMPERATURE)))
# ref scan_io_uos_rrgb.cc
register(FormatSpec("uos_rrgb", (XYZ, REFLECTANCE, RGB)))
# ref scan_io_xyz.cc:20-23
register(FormatSpec("xyz", (XYZ,), transform=_t_xyz))
# ref scan_io_xyzr.cc:20-23
register(FormatSpec("xyzr", (XYZ, REFLECTANCE), transform=_t_xyz))
# ref scan_io_xyz_rgb.cc:20-23
register(FormatSpec("xyz_rgb", (XYZ, RGB), transform=_t_xyz))
# ref scan_io_pts.cc
register(FormatSpec("pts", (XYZ,), transform=_t_pts, data_suffix=".pts"))
# ref scan_io_uos_normal.cc
register(FormatSpec("uos_normal", (XYZ, NORMAL)))
# ref scan_io_xyz_normal.cc
register(FormatSpec("xyz_normal", (XYZ, NORMAL), transform=_t_xyz))
# ref scan_io_uos_rgbr.cc:22-23
register(FormatSpec("uos_rgbr", (XYZ, RGB, REFLECTANCE)))
# ref scan_io_uosc.cc:20 (class/type column)
register(FormatSpec("uosc", (XYZ, TYPE)))
# ref scan_io_xyzc.cc:21-24
register(FormatSpec("xyzc", (XYZ, TYPE), transform=_t_xyz))
# ref scan_io_xyz_rgbr.cc:20-23
register(FormatSpec("xyz_rgbr", (XYZ, RGB, REFLECTANCE), transform=_t_xyz))
# ref scan_io_xyz_rrgb.cc:20-23
register(FormatSpec("xyz_rrgb", (XYZ, REFLECTANCE, RGB), transform=_t_xyz))
# ref scan_io_xyz_rgba.cc:21-24 (4th channel read as reflectance)
register(FormatSpec("xyz_rgba", (XYZ, RGB, REFLECTANCE), transform=_t_xyz))
# ref scan_io_ptsr.cc:20-23
register(FormatSpec("ptsr", (XYZ, REFLECTANCE), transform=_t_pts, data_suffix=".pts"))
# ref scan_io_pts_rgb.cc:21-24
register(FormatSpec("pts_rgb", (XYZ, RGB), transform=_t_pts, data_suffix=".pts"))
# ref scan_io_pts_rgbr.cc:21-24
register(FormatSpec("pts_rgbr", (XYZ, RGB, REFLECTANCE), transform=_t_pts, data_suffix=".pts"))
# ref scan_io_pts_rrgb.cc:21-24
register(FormatSpec("pts_rrgb", (XYZ, REFLECTANCE, RGB), transform=_t_pts, data_suffix=".pts"))
# ref scan_io_riegl_txt.cc:24-27: data scanNNN.txt (first line = count),
# pose scanNNN.dat holding a 4x4 col-major matrix; columns
# x y z range theta phi reflectance in the RIEGL right-handed m frame
register(
    FormatSpec(
        "riegl_txt",
        (XYZ, DUMMY, DUMMY, DUMMY, REFLECTANCE),
        transform=_t_xyz,
        data_suffix=".txt",
        pose_suffix=".dat",
        skip_header_lines=1,
        pose_reader="riegl",
    )
)
# ref scan_io_riegl_rgb.cc:30-36: scanNNN.rgb, x y z ? ? ? r g b refl
register(
    FormatSpec(
        "riegl_rgb",
        (XYZ, DUMMY, DUMMY, DUMMY, RGB, REFLECTANCE),
        transform=_t_xyz,
        data_suffix=".rgb",
        pose_suffix=".dat",
        skip_header_lines=1,
        pose_reader="riegl",
    )
)
# ref scan_io_faro_xyz_rgbr.cc:19-23: scanNNN.xyz, cols: ? ? x y z r g b refl
register(
    FormatSpec(
        "faro_xyz_rgbr",
        (DUMMY, DUMMY, XYZ, RGB, REFLECTANCE),
        transform=_t_xyz,
        data_suffix=".xyz",
    )
)
# ref scan_io_leica_xyzr.cc:23-27: scanNNN.xyz with 1 header line; the
# reference spec declares only two DATA_RGB columns (a latent reader bug) —
# we read those two columns as dummies and keep the reflectance column
register(
    FormatSpec(
        "leica_xyzr",
        (XYZ, DUMMY, DUMMY, REFLECTANCE),
        transform=_t_xyz,
        data_suffix=".xyz",
        skip_header_lines=1,
    )
)
# ref scan_io_ks.cc:26-41 (+ ks_rgb.cc:39-43): CAD-map frame, 1 header line
register(
    FormatSpec("ks", (XYZ,), transform=_t_ks, skip_header_lines=1, pose_reader="ks")
)
register(
    FormatSpec(
        "ks_rgb",
        (XYZ, RGB, AMPLITUDE, REFLECTANCE),
        transform=_t_ks,
        skip_header_lines=1,
        pose_reader="ks",
    )
)
# ref scan_io_rts.cc:31-34: mm frame + type flags; points with
# (type & 0x10) are invalid and dropped (helper.cc:48-52)
register(
    FormatSpec(
        "rts", (XYZ, TYPE, DUMMY, DUMMY), transform=_t_rts, invalid_type_mask=0x10
    )
)
# ref scan_io_laz.cc:45-65,134-141: binary LAS/LAZ via lastools; here a
# pure-numpy LAS reader (io/las.py); coordinates are pts-style (negate z)
register(
    FormatSpec(
        "laz",
        (XYZ, REFLECTANCE),
        transform=_t_pts,
        data_suffix=".laz",
        alt_suffixes=(".las",),
        binary="las",
    )
)
register(
    FormatSpec(
        "las",
        (XYZ, REFLECTANCE),
        transform=_t_pts,
        data_suffix=".las",
        alt_suffixes=(".laz",),
        binary="las",
    )
)
# ref scan_io_velodyne.cc:48-54,319-460: raw HDL-64 packet captures,
# scanNNN.bin; decode in io/velodyne.py (vectorized)
register(
    FormatSpec(
        "velodyne",
        (XYZ, REFLECTANCE),
        data_suffix=".bin",
        binary="velodyne",
    )
)


def get_format(name: str) -> FormatSpec:
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(
            f"unknown scan format {name!r}; known: {sorted(FORMATS)}"
        ) from None


def parse_scan_text(
    raw: np.ndarray, spec: FormatSpec
) -> dict[str, np.ndarray]:
    """Split a loaded [N, ncols] float array into named channels and apply
    the format's coordinate transform.  Returns {"xyz": [N,3], ...}.
    """
    if raw.ndim == 1:
        raw = raw.reshape(1, -1)
    channels: dict[str, np.ndarray] = {}
    col = 0
    for c in spec.columns:
        w = _NCOLS.get(c, 1)
        if c == DUMMY:
            col += w
            continue
        data = raw[:, col : col + w]
        if w == 1:
            data = data[:, 0]
        channels[c] = np.ascontiguousarray(data)
        col += w
    if spec.invalid_type_mask and TYPE in channels:
        keep = (channels[TYPE].astype(np.int64) & spec.invalid_type_mask) == 0
        channels = {k: v[keep] for k, v in channels.items()}
    channels[XYZ] = spec.transform(np.asarray(channels[XYZ], dtype=np.float64))
    if RGB in channels:
        channels[RGB] = channels[RGB].astype(np.uint8)
    return channels

# ASTM E57 (binary; 3rdparty/e57 + src/slam6d/e572scan.cc in the
# reference).  Right-handed metres -> uos cm like xyz formats.
register(
    FormatSpec(
        "e57",
        (XYZ,),
        transform=_t_xyz,
        data_suffix=".e57",
        binary="e57",
    )
)
