"""GPS utilities — the port of ``tpu3dtk.models.gps`` (ref
src/gps/scan2utm.cc (Borrmann) + NMEA tooling with minmea; SURVEY §2.6).
A numpy copy: host work in f64, bit-identical to the JAX package's.

Implements the WGS84 -> UTM projection (Karney-style series truncated
as in the classic USGS formulation, sub-centimetre for SLAM use) and
the scan2utm transformation: shift registered scans into UTM
coordinates from a reference lat/lon."""

from __future__ import annotations

import numpy as np

__all__ = ["latlon_to_utm", "scan_to_utm"]

_A = 6378137.0  # WGS84 semi-major (m)
_F = 1 / 298.257223563
_E2 = _F * (2 - _F)
_K0 = 0.9996


def latlon_to_utm(lat_deg, lon_deg):
    """WGS84 geodetic -> UTM (easting m, northing m, zone).

    Standard transverse-Mercator series (USGS PP1395 eq. 8-9..8-15).
    """
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    zone = (np.floor((np.asarray(lon_deg) + 180.0) / 6.0) + 1).astype(int)
    lon0 = np.deg2rad((zone - 1) * 6.0 - 180.0 + 3.0)

    ep2 = _E2 / (1 - _E2)
    N = _A / np.sqrt(1 - _E2 * np.sin(lat) ** 2)
    T = np.tan(lat) ** 2
    C = ep2 * np.cos(lat) ** 2
    Aa = (lon - lon0) * np.cos(lat)
    M = _A * (
        (1 - _E2 / 4 - 3 * _E2**2 / 64 - 5 * _E2**3 / 256) * lat
        - (3 * _E2 / 8 + 3 * _E2**2 / 32 + 45 * _E2**3 / 1024) * np.sin(2 * lat)
        + (15 * _E2**2 / 256 + 45 * _E2**3 / 1024) * np.sin(4 * lat)
        - (35 * _E2**3 / 3072) * np.sin(6 * lat)
    )
    easting = _K0 * N * (
        Aa + (1 - T + C) * Aa**3 / 6
        + (5 - 18 * T + T**2 + 72 * C - 58 * ep2) * Aa**5 / 120
    ) + 500000.0
    northing = _K0 * (
        M + N * np.tan(lat) * (
            Aa**2 / 2
            + (5 - T + 9 * C + 4 * C**2) * Aa**4 / 24
            + (61 - 58 * T + T**2 + 600 * C - 330 * ep2) * Aa**6 / 720
        )
    )
    northing = np.where(lat < 0, northing + 10000000.0, northing)
    return easting, northing, zone


def scan_to_utm(points_cm: np.ndarray, ref_lat: float, ref_lon: float, ref_alt_m: float = 0.0):
    """Shift a registered cloud (cm, local y-up frame) into UTM metres:
    x -> easting, z -> northing, y -> altitude (ref scan2utm output
    convention).  Returns [N, 3] (E, N, alt) in metres."""
    e, n, _ = latlon_to_utm(ref_lat, ref_lon)
    p = np.asarray(points_cm, np.float64) / 100.0
    out = np.empty_like(p)
    out[:, 0] = e + p[:, 0]
    out[:, 1] = n + p[:, 2]
    out[:, 2] = ref_alt_m + p[:, 1]
    return out
