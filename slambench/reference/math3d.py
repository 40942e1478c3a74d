"""3DTK pose algebra in f64 numpy: frozen copies of the formulas of
3DTK's globals.icc (Euler angles, quaternions, rigid inverse), the same
formulas ``tpu3dtk_torch.core.math3d`` implements, written here for one
backend so that the reference shares no code with the program."""

from __future__ import annotations

import numpy as np


def euler_to_matrix3(theta):
    theta = np.asarray(theta, np.float64)
    sx, sy, sz = (np.sin(theta[..., i]) for i in range(3))
    cx, cy, cz = (np.cos(theta[..., i]) for i in range(3))
    rows = [
        [cy * cz, -cy * sz, sy],
        [sx * sy * cz + cx * sz, -sx * sy * sz + cx * cz, -sx * cy],
        [-cx * sy * cz + sx * sz, cx * sy * sz + sx * cz, cx * cy],
    ]
    return np.stack([np.stack(r, -1) for r in rows], -2)


def euler_to_matrix4(pos, theta):
    R = euler_to_matrix3(theta)
    T = np.zeros(R.shape[:-2] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = pos
    T[..., 3, 3] = 1.0
    return T


def matrix4_to_euler(T):
    """(theta, pos) with Matrix4ToEuler's branches (globals.icc:540-583)."""
    T = np.asarray(T, np.float64)
    a0 = T[..., 0, 0]
    a8 = np.clip(T[..., 0, 2], -1.0, 1.0)
    th_y = np.where(a0 > 0.0, np.arcsin(a8), np.pi - np.arcsin(a8))
    C = np.cos(th_y)
    gimbal = np.abs(C) <= 0.005
    Cs = np.where(gimbal, 1.0, C)
    th_x = np.where(gimbal, 0.0, np.arctan2(-T[..., 1, 2] / Cs, T[..., 2, 2] / Cs))
    th_z = np.where(gimbal, np.arctan2(T[..., 1, 0], T[..., 1, 1]), np.arctan2(-T[..., 0, 1] / Cs, T[..., 0, 0] / Cs))
    return np.stack([th_x, th_y, th_z], -1), T[..., :3, 3].copy()


def matrix4_to_quat(T):
    """Unit quaternion [w, x, y, z] of a rotation (Shepperd's method)."""
    m = np.asarray(T, np.float64)[:3, :3]
    tr = np.trace(m)
    cand = np.array([1.0 + tr, 1.0 + m[0, 0] - m[1, 1] - m[2, 2],
                     1.0 - m[0, 0] + m[1, 1] - m[2, 2], 1.0 - m[0, 0] - m[1, 1] + m[2, 2]]) / 4.0
    k = int(np.argmax(cand))
    s = np.sqrt(max(cand[k], 1e-30))
    if k == 0:
        q = [s, (m[2, 1] - m[1, 2]) / (4 * s), (m[0, 2] - m[2, 0]) / (4 * s), (m[1, 0] - m[0, 1]) / (4 * s)]
    elif k == 1:
        q = [(m[2, 1] - m[1, 2]) / (4 * s), s, (m[1, 0] + m[0, 1]) / (4 * s), (m[0, 2] + m[2, 0]) / (4 * s)]
    elif k == 2:
        q = [(m[0, 2] - m[2, 0]) / (4 * s), (m[1, 0] + m[0, 1]) / (4 * s), s, (m[2, 1] + m[1, 2]) / (4 * s)]
    else:
        q = [(m[1, 0] - m[0, 1]) / (4 * s), (m[0, 2] + m[2, 0]) / (4 * s), (m[2, 1] + m[1, 2]) / (4 * s), s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def quat_to_matrix3(q):
    w, x, y, z = q
    return np.array([
        [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z],
    ])


def quat_to_matrix4(q, pos):
    T = np.eye(4)
    T[:3, :3] = quat_to_matrix3(q)
    T[:3, 3] = pos
    return T


def m4inv(T):
    T = np.asarray(T, np.float64)
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def orthonormal(T):
    """T with its rotation projected onto SO(3) by SVD."""
    T = np.asarray(T, np.float64).copy()
    u, _, vt = np.linalg.svd(T[:3, :3])
    T[:3, :3] = u @ vt
    return T


def slerp(q0, q1, t):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -np.asarray(q1), -d
    th = np.arccos(min(1.0, max(-1.0, d)))
    if th < 1e-8:
        out = (1 - t) * np.asarray(q0) + t * np.asarray(q1)
    else:
        out = (np.sin((1 - t) * th) * np.asarray(q0) + np.sin(t * th) * np.asarray(q1)) / np.sin(th)
    return out / np.linalg.norm(out)


def box_gap(Ta, Tb, lo, hi) -> float:
    """The largest distance (cm) by which two poses place a point of the
    box [lo, hi] (a scan's extent in its local frame): |(Ta - Tb) p| is
    convex in p, so its maximum over the box is at a corner."""
    corners = np.array([[x, y, z, 1.0] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    diff = (np.asarray(Ta, np.float64) - np.asarray(Tb, np.float64)) @ corners.T
    return float(np.sqrt((diff[:3] ** 2).sum(0)).max())
