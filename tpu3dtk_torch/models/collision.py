"""Collision detection — the port of ``tpu3dtk.models.collision`` (the
reference's src/collision/collision_model.cc: per trajectory pose, count
the model points within a collision radius of the environment; kd-tree
or CUDA grid backend).

:func:`detect_collisions` prepares the environment once
(``ops.nn.prepare_brute_model``) and makes one brute NN call a pose
(``ops.nn.nn_brute_auto``: the CUDA kernel K1 on a card, so K1 launches
once a pose; the plain version on the CPU) with the strict d² < r² gate.
:func:`sweep_collisions` ORs ``ops.search.segment_search_all`` over the
trajectory's segments on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["CollisionParams", "detect_collisions", "sweep_collisions"]


@dataclasses.dataclass
class CollisionParams:
    radius: float = 10.0  # collision distance (cm)


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    from .. import default_device

    return default_device()


def detect_collisions(environment, model, poses, params: CollisionParams | None = None,
                      device=None):
    """Returns (colliding [P] bool, n_hits [P] int32) numpy: per pose, how
    many model points lie within ``radius`` of the environment.  Runs on
    ``device`` (None: the first CUDA card)."""
    from ..core import math3d
    from ..ops import nn as nn_ops

    params = params or CollisionParams()
    dev = _device(device)
    env = torch.as_tensor(np.asarray(environment, np.float32), device=dev)
    bm = nn_ops.prepare_brute_model(env, torch.ones(env.shape[0], dtype=torch.bool, device=dev))
    mdl = torch.as_tensor(np.asarray(model, np.float32), device=dev)
    mmask = torch.ones(mdl.shape[0], dtype=torch.bool, device=dev)
    poses_t = torch.as_tensor(np.asarray(poses, np.float32), device=dev)
    r2 = float(np.float32(params.radius**2))
    hits = torch.empty(poses_t.shape[0], dtype=torch.int32, device=dev)
    for i, T in enumerate(poses_t):
        moved = math3d.transform3(T, mdl).to(torch.float32).contiguous()
        _, _d2, found = nn_ops.nn_brute_auto(moved, mmask, bm, None, r2)
        hits[i] = found.sum()
    hits = hits.cpu().numpy()
    return hits > 0, hits


def sweep_collisions(environment, trajectory, radius: float, device=None):
    """Swept-path collision: environment points within ``radius`` of ANY
    segment of the trajectory polyline (the reference's kd segment search
    behind collision sweeps, kdTreeImpl.h segmentSearch_all).

    trajectory: [P, 3] waypoints.  Returns (mask [N] bool numpy, n_hits)."""
    from ..ops import search as search_ops

    dev = _device(device)
    env = torch.as_tensor(np.asarray(environment, np.float32), device=dev)
    emask = torch.ones(env.shape[0], dtype=torch.bool, device=dev)
    r2 = float(np.float32(radius**2))
    hit = torch.zeros(env.shape[0], dtype=torch.bool, device=dev)
    traj = torch.as_tensor(np.asarray(trajectory, np.float32), device=dev)
    for a, b in zip(traj[:-1], traj[1:]):
        hit |= search_ops.segment_search_all(a, b, env, emask, r2)
    hit = hit.cpu().numpy()
    return hit, int(hit.sum())
