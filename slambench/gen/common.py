"""Shared pieces of the scan generators: a seeded device generator,
Gumbel top-k sampling proportional to a weight, and yaw-only poses.

Every draw comes from one ``torch.Generator`` on the device, seeded with
``--seed``, so one seed gives the same scans on one card and torch
version.  The scans are copied to the host once, as f32 numpy arrays,
the form a file read leaves them in.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=torch.float64)


def normal(g, shape, std, device):
    return std * torch.randn(shape, generator=g, device=device, dtype=torch.float64)


def randint(g, shape, hi, device):
    return torch.randint(0, hi, shape, generator=g, device=device)


def yaw_pose(center, yaw) -> np.ndarray:
    """4x4 f64 pose at ``center`` [3] turned by ``yaw`` about y: the 3DTK
    Euler pose (0, yaw, 0)."""
    c, s = math.cos(yaw), math.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    T[:3, 3] = center
    return T


def render_scans(g, env, poses, n_pts, range_max, near, noise, device, batch=8):
    """Scans of the f32 world points ``env`` [E,3] (device) from each 4x4
    pose: the points within ``range_max`` cm, ``n_pts`` of them drawn
    without replacement with probability ∝ 1/max(d², near²) (a scanner
    resolves near surfaces densely; Gumbel top-k), moved into the local
    frame, plus isotropic Gaussian noise of ``noise`` cm.  Returns a list
    of [n, 3] f32 numpy arrays."""
    out = []
    for b0 in range(0, len(poses), batch):
        Ts = torch.as_tensor(np.stack(poses[b0 : b0 + batch]), dtype=torch.float64, device=device)
        centers = Ts[:, :3, 3].to(torch.float32)
        d2 = ((env[None] - centers[:, None]) ** 2).sum(-1)  # [B, E]
        inr = d2 < range_max**2
        u = torch.rand(d2.shape, generator=g, device=device).clamp_(1e-12, 1.0 - 1e-7)
        keys = -torch.log(torch.clamp(d2, min=near**2)) - torch.log(-torch.log(u))
        keys = torch.where(inr, keys, float("-inf"))
        k = min(n_pts, env.shape[0])
        top = torch.topk(keys, k, dim=1)
        counts = inr.sum(1).tolist()
        for r in range(len(Ts)):
            sel = top.indices[r, : min(k, counts[r])]
            vis = env[sel].to(torch.float64)
            R, t = Ts[r, :3, :3], Ts[r, :3, 3]
            local = (vis - t) @ R  # R^T (p - t), as row vectors
            local = local + normal(g, local.shape, noise, device)
            out.append(local.to(torch.float32).cpu().numpy())
    return out


def drift_odometry(g, true_poses, drift, device) -> list[np.ndarray]:
    """Odometry poses: each true pose with an accumulated Gaussian
    translation drift of ``drift`` cm a scan and axis."""
    steps = normal(g, (len(true_poses), 3), drift, device).cumsum(0).cpu().numpy()
    out = []
    for T, d in zip(true_poses, steps):
        To = T.copy()
        To[:3, 3] += d
        out.append(To)
    return out
