"""``ConfigFileHough`` key-value config files — a copy of
``tpu3dtk.io.hough_config`` (pure Python; the port keeps its own so it
imports nothing of the JAX package).  The format drives the reference's
``bin/planes`` (src/shapes/ConfigFileHough.cc:LoadCfg:
the file is scanned for "Key value" tokens per parameter; unknown keys
are ignored, missing keys take the DEF_* defaults from
include/shapes/ConfigFileHough.h:4-24)."""

from __future__ import annotations

__all__ = ["HOUGH_DEFAULTS", "load_hough_config", "hough_params_from_config"]

# defaults = the reference's DEF_* table (ConfigFileHough.h:4-24)
HOUGH_DEFAULTS: dict[str, float | int | str | bool] = {
    "MaxDist": 500.0,
    "MinDist": 50.0,
    "AccumulatorMax": 100,
    "MinSizeAllPoints": 20,
    "RhoNum": 500,
    "ThetaNum": 360,
    "PhiNum": 176,
    "RhoMax": 1500.0,
    "MaxPointPlaneDist": 1.5,
    "MaxPlanes": 20,
    "MinPlaneSize": 100,
    "MinPlanarity": 0.3,
    "PlaneRatio": 0.5,
    "PointDist": 5.0,
    "PeakWindow": False,
    "WindowSize": 8,
    "TrashMax": 20,
    "AccumulatorType": 3,
    "PlaneDir": "dat/planes/",
}


def load_hough_config(path: str) -> dict:
    """Parse a ConfigFileHough file.  Token-scan semantics like the
    reference's paramtr_scan_*: any "Key value" pair anywhere in the
    file sets that key; everything else is ignored."""
    out = dict(HOUGH_DEFAULTS)
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    while i + 1 < len(tokens):
        key = tokens[i]
        if key in out:
            raw = tokens[i + 1]
            default = HOUGH_DEFAULTS[key]
            if isinstance(default, bool):
                out[key] = raw.lower() in ("1", "true", "yes")
            elif isinstance(default, int):
                out[key] = int(float(raw))
            elif isinstance(default, float):
                out[key] = float(raw)
            else:
                out[key] = raw
            i += 2
        else:
            i += 1
    return out


def hough_params_from_config(cfg: dict):
    """Map a ConfigFileHough dict onto the port's models.shapes.HoughParams
    (the accumulator resolutions, plane limits and inlier band)."""
    from ..models.shapes import HoughParams

    return HoughParams(
        n_theta=int(cfg["ThetaNum"]) // 4 or 1,
        n_phi=int(cfg["PhiNum"]),
        n_rho=int(cfg["RhoNum"]),
        rho_max=float(cfg["RhoMax"]),
        min_inliers=int(cfg["MinSizeAllPoints"]),
        max_planes=int(cfg["MaxPlanes"]),
        dist_tol=float(cfg["MaxPointPlaneDist"]),
    )
