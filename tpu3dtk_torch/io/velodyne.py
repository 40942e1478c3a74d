"""Velodyne HDL-64 raw capture decoder (.bin packet streams).

Re-implements the reference's velodyne reader
(src/scanio/scan_io_velodyne.cc:319-460) as a *vectorized* numpy decode:
the whole capture is viewed as a structured array and every firing is
converted in one shot, instead of the reference's per-packet scalar
loops.  File layout (scan_io_velodyne.cc:48-54):

  repeat CIRCLELENGTH (=360) times:
    58-byte pcap-style record header (BLOCK_OFFSET = 42+16, skipped)
    1206-byte data block = 12 x 100-byte firings + 6 status bytes
  each firing: u16 header (0xEEFF upper block / 0xDDFF lower),
    u16 rotational position (1/100 deg), 32 x (u16 distance [2 mm lsb],
    u8 intensity).

Geometry per point (scan_io_velodyne.cc:410-445): spherical shot with
per-laser calibration (vertical angle, rotational correction, distance
offset, vertical/horizontal offsets), then mapped into the uos frame
(x, z, -y) in cm.  Calibration comes from a ``calibration.txt`` CSV next
to the data when present (scan_io_velodyne.cc:256-310), else a default
HDL-64E table (evenly spaced vertical angles: upper block +2..-8.33 deg,
lower block -8.83..-24.33 deg — the hardware's nominal firing pattern).

The port's copy of ``tpu3dtk.io.velodyne`` (numpy only; the decode
stays on the host).
"""

from __future__ import annotations

import os

import numpy as np

from .vfs import vexists, vopen

BLOCK_OFFSET = 42 + 16
BLOCK_SIZE = 1206
CIRCLELENGTH = 360
RADIANS_PER_LSB = 0.0174532925
METERS_PER_LSB = 0.002


def default_calibration() -> np.ndarray:
    """[64, 6] table: vertCorrection[deg], rotCorrection[deg],
    distCorrection[cm], vertOffset[cm], horizOffset[cm], enabled."""
    cal = np.zeros((64, 6), dtype=np.float64)
    cal[:32, 0] = np.linspace(2.0, -8.33, 32)  # upper block
    cal[32:, 0] = np.linspace(-8.83, -24.33, 32)  # lower block
    cal[:, 5] = 1.0
    return cal


def read_calibration_csv(path: str) -> np.ndarray:
    """CSV with one header line then up to 64 rows of 6 comma-separated
    values (scan_io_velodyne.cc:256-310; <60 rows zero-fills 32..63)."""
    rows = []
    with vopen(path, "rb") as f:
        lines = f.read().decode("utf-8", "replace").splitlines()[1:]
    for line in lines:
        if not line.strip():
            continue
        vals = [float(v) for v in line.split(",")[:6]]
        rows.append(vals + [0.0] * (6 - len(vals)))
        if len(rows) == 64:
            break
    cal = np.zeros((64, 6), dtype=np.float64)
    if rows:
        cal[: len(rows)] = np.asarray(rows)
    if len(rows) < 60:
        cal[32:] = 0.0
    return cal


def decode_velodyne(
    buf: bytes, calibration: np.ndarray | None = None
) -> dict[str, np.ndarray]:
    """Decode a .bin capture into uos-frame channels.

    Returns {"xyz": [N,3] cm, "reflectance": [N]} with the reference's
    validity gates (distance in (2.2, 120) m, laser enabled,
    firing-header magic check: scan_io_velodyne.cc:381-407)."""
    cal = default_calibration() if calibration is None else calibration
    rec = BLOCK_OFFSET + BLOCK_SIZE
    ncirc = min(len(buf) // rec, CIRCLELENGTH)
    if ncirc == 0:
        return {"xyz": np.zeros((0, 3)), "reflectance": np.zeros(0, np.float64)}
    raw = np.frombuffer(buf[: ncirc * rec], dtype=np.uint8).reshape(ncirc, rec)
    blocks = raw[:, BLOCK_OFFSET : BLOCK_OFFSET + 1200].reshape(ncirc, 12, 100)

    head = blocks[:, :, 0].astype(np.uint16) | (
        blocks[:, :, 1].astype(np.uint16) << 8
    )  # [C,12] 0xEEFF upper / 0xDDFF lower
    rot = (
        blocks[:, :, 2].astype(np.uint16) | (blocks[:, :, 3].astype(np.uint16) << 8)
    ).astype(np.float64) / 100.0  # degrees
    body = blocks[:, :, 4:100].reshape(ncirc, 12, 32, 3)
    dist = (
        body[..., 0].astype(np.uint16) | (body[..., 1].astype(np.uint16) << 8)
    ).astype(np.float64) * METERS_PER_LSB  # metres
    inten = body[..., 2].astype(np.float64)

    # physical laser number: firing header selects block offset 0 or 32
    block_base = np.where(head == 0xDDFF, 32, 0)[..., None]  # [C,12,1]
    valid_head = ((head == 0xEEFF) | (head == 0xDDFF))[..., None]
    phys = block_base + np.arange(32)[None, None, :]  # [C,12,32]

    vert = np.deg2rad(cal[:, 0])[phys]
    rotc = np.deg2rad(cal[:, 1])[phys]
    dcorr = cal[phys, 2] / 100.0  # cm -> m
    voff = cal[phys, 3] / 100.0
    hoff = cal[phys, 4] / 100.0
    enabled = cal[phys, 5] > 0.5

    keep = valid_head & enabled & (dist > 2.2) & (dist < 120.0)
    ctheta = 2.0 * np.pi - np.deg2rad(rot)[..., None]  # [C,12,1] broadcast
    ctheta = np.where(ctheta >= 2.0 * np.pi, 0.0, ctheta)
    theta = ctheta + rotc  # mod2pi_ref(pi, .) only shifts by 2pi: sin/cos safe
    r = dist + dcorr
    cph, sph = np.cos(vert), np.sin(vert)
    x = r * np.cos(theta) * cph - hoff * np.cos(ctheta)
    y = r * np.sin(theta) * cph - hoff * np.sin(ctheta)
    z = r * sph + voff * cph
    # sensor frame -> uos (scan_io_velodyne.cc:442-445): (x, z, -y) * 100
    xyz = np.stack([x * 100.0, z * 100.0, -y * 100.0], axis=-1)
    keep_f = keep.reshape(-1)
    return {
        "xyz": xyz.reshape(-1, 3)[keep_f],
        "reflectance": inten.reshape(-1)[keep_f],
    }


def read_velodyne(path: str) -> dict[str, np.ndarray]:
    cal_path = os.path.join(os.path.dirname(path), "calibration.txt")
    cal = read_calibration_csv(cal_path) if vexists(cal_path) else None
    with vopen(path, "rb") as f:
        buf = f.read()
    return decode_velodyne(buf, cal)
