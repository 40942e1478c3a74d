"""City block scans, the bremen_city regime, made on the device.

A torch copy of ``tpu3dtk_torch.synth.synth_city``'s construction: a
ground plane of ``ground_points`` over a square of ``area_cm``, a 4 x 4
grid of building blocks (``block_cm`` squares ``pitch_cm`` apart, each
``facade_points`` on its four facades, heights drawn from
``height_cm``), and ``n_scans`` terrestrial scans along an L-shaped
street, each ``points_per_scan`` raw points within ``range_cm`` drawn ∝
1/max(d², 300²), with ``noise_cm`` of noise and ``drift_cm`` of
odometry drift a scan.  The draws come from a torch generator on the
card, not numpy's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import common


def _world(g, sc, device):
    area, n_g = sc["area_cm"], int(sc["ground_points"])
    gxz = common.uniform(g, (n_g, 2), 0.0, area, device)
    parts = [torch.stack([gxz[:, 0], torch.zeros(n_g, dtype=torch.float64, device=device), gxz[:, 1]], 1)]
    blk, pitch, org = sc["block_cm"], sc["pitch_cm"], sc["origin_cm"]
    nf = int(sc["facade_points"])
    lo, hi = sc["height_cm"]
    for bx in range(4):
        for bz in range(4):
            x0, z0 = org + bx * pitch, org + bz * pitch
            h = float(common.uniform(g, 1, lo, hi, device))
            side = common.randint(g, (nf,), 4, device)
            u = common.uniform(g, nf, 0.0, 1.0, device)
            yy = common.uniform(g, nf, 0.0, h, device)
            xx = torch.where(side == 0, x0, torch.where(side == 1, x0 + blk, x0 + u * blk))
            zz = torch.where(side == 2, z0, torch.where(side == 3, z0 + blk, z0 + u * blk))
            xx = torch.where(side >= 2, x0 + u * blk, xx)
            zz = torch.where(side < 2, z0 + u * blk, zz)
            parts.append(torch.stack([xx, yy, zz], 1))
    return torch.cat(parts).to(torch.float32)


def street_poses(n_scans: int, y_cm: float) -> list[np.ndarray]:
    """The L-shaped street of synth_city: north along x = 2900 cm, then
    east along z = 11500 cm."""
    poses = []
    for t in np.linspace(0.0, 1.0, n_scans):
        if t < 0.5:
            poses.append(common.yaw_pose([2900.0, y_cm, 1500.0 + t * 2 * 10000.0], 0.0))
        else:
            poses.append(common.yaw_pose([2900.0 + (t - 0.5) * 2 * 9000.0, y_cm, 11500.0], -math.pi / 2))
    return poses


def generate(scene: dict, n_sets: int, seed: int, device) -> list[dict]:
    """``n_sets`` independent cities from ``seed`` (see ring.generate)."""
    g = common.generator(seed, device)
    sets = []
    for _ in range(n_sets):
        env = _world(g, scene, device)
        true = street_poses(int(scene["n_scans"]), scene["scanner_height_cm"])
        locals_ = common.render_scans(
            g, env, true, int(scene["points_per_scan"]), scene["range_cm"], 300.0,
            scene["noise_cm"], device, batch=2,
        )
        odo = common.drift_odometry(g, true, scene["drift_cm"], device)
        sets.append({"locals": locals_, "odo": odo, "true": true})
        del env
    return sets
