"""Ring corridor scans, the hannover2 regime, made on the device.

A torch copy of ``tpu3dtk_torch.synth.synth_ring``'s construction (which
is numpy on the host and takes ~52 s for 468 scans): a ring corridor of
two cylindrical walls, floor and ceiling (``surface_samples`` points,
area-blind), pillars on the centre line every ``pillar_step_deg``, and
``floor_boxes`` clutter boxes that anchor the tangential direction.  The
sensor drives ``laps`` laps in ``n_scans`` stops; each scan takes
``points_per_scan`` points within ``8 * half_width`` cm, drawn ∝ 1/d²,
with ``noise_cm`` of sensor noise, and the odometry drifts by
``drift_cm`` a scan.  The draws differ from ``synth_ring``'s (one torch
generator on the card, not numpy's), the distributions are the same.
"""

from __future__ import annotations

import math

import torch

from . import common


def _world(g, sc, device):
    R, hw, hh = sc["radius_cm"], sc["half_width_cm"], sc["half_height_cm"]
    n = int(sc["surface_samples"])
    phi = common.uniform(g, n, 0.0, 2 * math.pi, device)
    kind = common.randint(g, (n,), 4, device)
    r = torch.where(kind == 0, R - hw, torch.where(kind == 1, R + hw, common.uniform(g, n, R - hw, R + hw, device)))
    y = torch.where(kind == 2, -hh, torch.where(kind == 3, hh, common.uniform(g, n, -hh, hh, device)))
    parts = [torch.stack([r * torch.cos(phi), y, r * torch.sin(phi)], 1)]

    step = math.radians(sc["pillar_step_deg"])
    centers = torch.arange(0.0, 2 * math.pi - 1e-9, step, dtype=torch.float64, device=device)
    npil = int(sc["pillar_points"])
    ang = common.uniform(g, (len(centers), npil), 0.0, 2 * math.pi, device)
    py = common.uniform(g, (len(centers), npil), -hh, hh, device)
    pr = sc["pillar_radius_cm"]
    cx, cz = (R * torch.cos(centers))[:, None], (R * torch.sin(centers))[:, None]
    parts.append(torch.stack([cx + pr * torch.cos(ang), py, cz + pr * torch.sin(ang)], -1).reshape(-1, 3))

    nb, nbp = int(sc["floor_boxes"]), int(sc["box_points"])
    a = common.uniform(g, (nb, 1), 0.0, 2 * math.pi, device)
    br = common.uniform(g, (nb, 1), R - hw + 60, R + hw - 60, device)
    w, d, h = (common.uniform(g, (nb, 1), 40.0, 160.0, device) for _ in range(3))
    yaw = common.uniform(g, (nb, 1), 0.0, 2 * math.pi, device)
    face = common.randint(g, (nb, nbp), 5, device)  # 4 sides + top
    u = common.uniform(g, (nb, nbp), 0.0, 1.0, device)
    v = common.uniform(g, (nb, nbp), 0.0, 1.0, device)
    bx = torch.where(face == 0, 0.0, torch.where(face == 1, w, u * w))
    bz = torch.where(face == 2, 0.0, torch.where(face == 3, d, v * d))
    bx = torch.where(face >= 2, u * w, bx) - w / 2
    bz = torch.where(face < 2, v * d, bz) - d / 2
    by = torch.where(face == 4, h, v * h)
    ca, sa = torch.cos(yaw), torch.sin(yaw)
    c0, c2 = br * torch.cos(a), br * torch.sin(a)
    parts.append(torch.stack([c0 + ca * bx - sa * bz, -hh + by, c2 + sa * bx + ca * bz], -1).reshape(-1, 3))
    return torch.cat(parts).to(torch.float32)


def generate(scene: dict, n_sets: int, seed: int, device) -> list[dict]:
    """``n_sets`` independent rings from ``seed``: each a dict of
    ``locals`` (list of [n, 3] f32 numpy, local frames), ``odo`` and
    ``true`` (lists of 4x4 f64 poses)."""
    g = common.generator(seed, device)
    R, S, laps = scene["radius_cm"], int(scene["n_scans"]), scene["laps"]
    sets = []
    for _ in range(n_sets):
        env = _world(g, scene, device)
        true = []
        for k in range(S):
            ang = laps * 2 * math.pi * k / S
            true.append(common.yaw_pose([R * math.cos(ang), 0.0, R * math.sin(ang)], -ang))
        locals_ = common.render_scans(
            g, env, true, int(scene["points_per_scan"]), 8.0 * scene["half_width_cm"],
            100.0, scene["noise_cm"], device,
        )
        odo = common.drift_odometry(g, true, scene["drift_cm"], device)
        sets.append({"locals": locals_, "odo": odo, "true": true})
        del env
    return sets
