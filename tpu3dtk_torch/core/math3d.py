"""Pose math core: Euler/quaternion/matrix conversions, 3DTK conventions.

Re-implements the semantics of the reference's header-only math core
(``include/slam6d/globals.icc:282-651``).  Conventions:

- Coordinate system: left-handed, y-up, z-depth, centimetre units
  (ref: doc/high_level_doc/documentation.tex:454-492).
- The reference stores 4x4 matrices as OpenGL *column-major* 16-vectors
  ``M[col*4 + row]``.  Here a pose is a standard ``(4, 4)`` array ``T``
  with ``p' = T @ [p, 1]`` (i.e. ``T[row, col] = M16[col*4 + row]``);
  :func:`from_colmajor16` / :func:`to_colmajor16` convert at file-format
  boundaries (.pose / .frames).
- Euler convention matches ``EulerToMatrix4`` (globals.icc:504-538) and
  ``Matrix4ToEuler`` (globals.icc:540-583) element-for-element, including
  the gimbal-lock branches, so .pose files round-trip identically.

Dual-backend: every function dispatches on its inputs — numpy arrays
run in numpy (fast host pose chains in f64, no device round-trips);
torch tensors run in torch on the tensor's own device (branchless via
where).  The formulas are shared, and are those of the JAX package.
Passing ``xp=torch`` forces the torch backend.
"""

from __future__ import annotations

import numpy as _np
import torch

__all__ = [
    "euler_to_matrix3",
    "euler_to_matrix4",
    "matrix4_to_euler",
    "matrix4_to_quat",
    "quat_to_matrix3",
    "quat_to_matrix4",
    "from_colmajor16",
    "to_colmajor16",
    "m4inv",
    "transform3",
    "transform3normal",
    "pose_to_matrix",
    "matrix_to_pose",
    "rad",
    "deg",
    "fma_f32",
    "norm3_f32",
]


class _TorchXP:
    """The numpy names these formulas use, in torch, on one device."""

    def __init__(self, device):
        self.device = device

    def __getattr__(self, name):
        return getattr(torch, name)

    def asarray(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    @staticmethod
    def take_along_axis(a, idx, axis):
        return torch.take_along_dim(a, idx, dim=axis)


def _xp(*arrays):
    """numpy for pure-numpy/python inputs, torch (on the first tensor's
    device) if any arg is a torch tensor."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return _TorchXP(a.device)
    return _np


def _resolve(xp, *arrays):
    """Explicit ``xp`` (numpy or the torch module) or dispatch."""
    if xp is None:
        return _xp(*arrays)
    if xp is torch:
        t = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
        return _TorchXP(t.device if t is not None else torch.device("cpu"))
    return xp


def rad(x, xp=None):
    """Degrees -> radians (ref globals.icc ``rad``)."""
    xp = _resolve(xp, x)
    return xp.asarray(x) * (_np.pi / 180.0)


def deg(x, xp=None):
    """Radians -> degrees (ref globals.icc ``deg``)."""
    xp = _resolve(xp, x)
    return xp.asarray(x) * (180.0 / _np.pi)


def euler_to_matrix3(theta, xp=None):
    """3x3 rotation from 3DTK Euler angles (ref globals.icc:361-383).

    theta: (..., 3) radians.  Returns (..., 3, 3) with the exact element
    layout of ``EulerToMatrix3`` (reference writes column-major;
    transposed here into standard [row, col]).
    """
    xp = _resolve(xp, theta)
    theta = xp.asarray(theta)
    sx, sy, sz = (xp.sin(theta[..., i]) for i in range(3))
    cx, cy, cz = (xp.cos(theta[..., i]) for i in range(3))
    r00 = cy * cz
    r10 = sx * sy * cz + cx * sz
    r20 = -cx * sy * cz + sx * sz
    r01 = -cy * sz
    r11 = -sx * sy * sz + cx * cz
    r21 = cx * sy * sz + sx * cz
    r02 = sy
    r12 = -sx * cy
    r22 = cx * cy
    return xp.stack(
        [
            xp.stack([r00, r01, r02], axis=-1),
            xp.stack([r10, r11, r12], axis=-1),
            xp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def _embed44(xp, R, pos=None):
    """Build (...,4,4) from (...,3,3) rotation and optional translation."""
    batch = R.shape[:-2]
    dtype = R.dtype
    if pos is None:
        pos = xp.zeros(batch + (3,), dtype=dtype)
    else:
        pos = xp.broadcast_to(xp.asarray(pos, dtype=dtype), batch + (3,))
    top = xp.concatenate([R, pos[..., :, None]], axis=-1)  # (...,3,4)
    bottom = xp.broadcast_to(
        xp.asarray([0.0, 0.0, 0.0, 1.0], dtype=dtype), batch + (1, 4)
    )
    return xp.concatenate([top, bottom], axis=-2)


def euler_to_matrix4(pos, theta, xp=None):
    """4x4 pose from position + 3DTK Euler angles (ref globals.icc:504-538)."""
    xp = _resolve(xp, pos, theta)
    R = euler_to_matrix3(theta, xp)
    pos = xp.asarray(pos, dtype=R.dtype)
    batch = _np.broadcast_shapes(pos.shape[:-1], R.shape[:-2])
    R = xp.broadcast_to(R, batch + (3, 3))
    return _embed44(xp, R, pos)


def matrix4_to_euler(T, xp=None):
    """Inverse of euler_to_matrix4, exact branch structure of
    ``Matrix4ToEuler`` (ref globals.icc:540-583).

    T: (..., 4, 4). Returns (theta (...,3), pos (...,3)).
    """
    xp = _resolve(xp, T)
    T = xp.asarray(T)
    a0 = T[..., 0, 0]
    a8 = xp.clip(T[..., 0, 2], -1.0, 1.0)
    th_y = xp.where(a0 > 0.0, xp.arcsin(a8), _np.pi - xp.arcsin(a8))
    C = xp.cos(th_y)
    gimbal = xp.abs(C) <= 0.005
    Csafe = xp.where(gimbal, 1.0, C)
    th_x = xp.arctan2(-T[..., 1, 2] / Csafe, T[..., 2, 2] / Csafe)
    th_z = xp.arctan2(-T[..., 0, 1] / Csafe, T[..., 0, 0] / Csafe)
    th_x = xp.where(gimbal, 0.0, th_x)
    th_z = xp.where(gimbal, xp.arctan2(T[..., 1, 0], T[..., 1, 1]), th_z)
    theta = xp.stack([th_x, th_y, th_z], axis=-1)
    pos = T[..., :3, 3]
    return theta, pos


def matrix4_to_quat(T, xp=None):
    """Rotation part -> unit quaternion [w, x, y, z].

    Matches ``Matrix4ToQuat`` (ref globals.icc:586-651: max-diagonal
    selection, Shepperd's method) up to the global sign of q.
    """
    xp = _resolve(xp, T)
    T = xp.asarray(T)
    m00, m11, m22 = T[..., 0, 0], T[..., 1, 1], T[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = xp.maximum(xp.zeros_like(tr), 1.0 + tr) / 4.0
    qx2 = xp.maximum(xp.zeros_like(tr), 1.0 + m00 - m11 - m22) / 4.0
    qy2 = xp.maximum(xp.zeros_like(tr), 1.0 - m00 + m11 - m22) / 4.0
    qz2 = xp.maximum(xp.zeros_like(tr), 1.0 - m00 - m11 + m22) / 4.0
    r21_r12 = T[..., 2, 1] - T[..., 1, 2]
    r02_r20 = T[..., 0, 2] - T[..., 2, 0]
    r10_r01 = T[..., 1, 0] - T[..., 0, 1]
    r10p = T[..., 1, 0] + T[..., 0, 1]
    r02p = T[..., 0, 2] + T[..., 2, 0]
    r21p = T[..., 2, 1] + T[..., 1, 2]
    qs = xp.stack([qw2, qx2, qy2, qz2], axis=-1)
    best = xp.argmax(qs, axis=-1)
    sw = xp.sqrt(xp.maximum(qw2, xp.full_like(qw2, 1e-30)))
    sx = xp.sqrt(xp.maximum(qx2, xp.full_like(qx2, 1e-30)))
    sy = xp.sqrt(xp.maximum(qy2, xp.full_like(qy2, 1e-30)))
    sz = xp.sqrt(xp.maximum(qz2, xp.full_like(qz2, 1e-30)))
    cand_w = xp.stack([sw, r21_r12 / (4 * sw), r02_r20 / (4 * sw), r10_r01 / (4 * sw)], -1)
    cand_x = xp.stack([r21_r12 / (4 * sx), sx, r10p / (4 * sx), r02p / (4 * sx)], -1)
    cand_y = xp.stack([r02_r20 / (4 * sy), r10p / (4 * sy), sy, r21p / (4 * sy)], -1)
    cand_z = xp.stack([r10_r01 / (4 * sz), r02p / (4 * sz), r21p / (4 * sz), sz], -1)
    cands = xp.stack([cand_w, cand_x, cand_y, cand_z], axis=-2)
    idx = best[..., None, None]
    q = xp.take_along_axis(cands, idx.astype(_np.int64) if xp is _np else idx, axis=-2)[
        ..., 0, :
    ]
    norm = xp.sqrt(xp.sum(q * q, axis=-1, keepdims=True))
    return q / norm


def quat_to_matrix3(q, xp=None):
    """Unit quaternion [w,x,y,z] -> 3x3 rotation (ref icp6Dquat.cc:149-169
    ``quaternion2matrix``)."""
    xp = _resolve(xp, q)
    q = xp.asarray(q)
    w, x, y, z = (q[..., i] for i in range(4))
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wz, xz, yz = w * z, x * z, y * z
    wy, xy, wx = w * y, x * y, w * x
    return xp.stack(
        [
            xp.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], -1),
            xp.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], -1),
            xp.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], -1),
        ],
        axis=-2,
    )


def quat_to_matrix4(q, pos=None, xp=None):
    xp = _resolve(xp, q, pos)
    R = quat_to_matrix3(q, xp)
    return _embed44(xp, R, pos)


def from_colmajor16(m16, xp=None):
    """OpenGL column-major 16-vector (the reference's in-memory & .frames
    layout) -> (4,4) standard matrix."""
    xp = _resolve(xp, m16)
    m16 = xp.asarray(m16)
    return m16.reshape(m16.shape[:-1] + (4, 4)).swapaxes(-1, -2)


def to_colmajor16(T, xp=None):
    """(4,4) standard matrix -> column-major 16-vector."""
    xp = _resolve(xp, T)
    T = xp.asarray(T)
    return T.swapaxes(-1, -2).reshape(T.shape[:-2] + (16,))


def m4inv(T, xp=None):
    """Inverse of a rigid 4x4 pose (ref globals.icc ``M4inv``): R^T,
    -R^T t closed form."""
    xp = _resolve(xp, T)
    T = xp.asarray(T)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = xp.swapaxes(R, -1, -2)
    ti = -xp.einsum("...ij,...j->...i", Rt, t)
    return _embed44(xp, Rt, ti)


def transform3(T, pts, xp=None):
    """Apply pose to points (ref globals.icc ``transform3``/``PMult``).

    T: (..., 4, 4); pts: (..., N, 3) -> (..., N, 3).
    """
    xp = _resolve(xp, T, pts)
    T = xp.asarray(T)
    pts = xp.asarray(pts)
    if xp is not _np:  # torch.einsum wants one dtype; promote as numpy does
        dt = torch.promote_types(T.dtype, pts.dtype)
        T, pts = T.to(dt), pts.to(dt)
    return (
        xp.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]
    )


def transform3normal(T, normals, xp=None):
    """Apply rotation only (ref globals.icc ``transform3normal``)."""
    xp = _resolve(xp, T, normals)
    T = xp.asarray(T)
    normals = xp.asarray(normals)
    if xp is not _np:
        dt = torch.promote_types(T.dtype, normals.dtype)
        T, normals = T.to(dt), normals.to(dt)
    return xp.einsum("...ij,...nj->...ni", T[..., :3, :3], normals)


def pose_to_matrix(pos, theta_deg, xp=None):
    """.pose file semantics: position + Euler angles in degrees -> 4x4
    (ref src/scanio/scan_io.cc readPose + scan.cc:268-279)."""
    xp = _resolve(xp, pos, theta_deg)
    return euler_to_matrix4(xp.asarray(pos), rad(xp.asarray(theta_deg), xp), xp)


def matrix_to_pose(T, xp=None):
    """4x4 -> (pos, theta_degrees), inverse of pose_to_matrix."""
    xp = _resolve(xp, T)
    theta, pos = matrix4_to_euler(T, xp)
    return pos, deg(theta, xp)


def fma_f32(a, b, c):
    """a·b + c for f32 tensors, rounded once to f32: the fused multiply-add
    XLA emits for a product feeding a sum, so elementwise formulas of the
    JAX package round as they do there.  The f32 product is exact in f64;
    the f64 sum is rounded to f32 (a double rounding, which differs from
    one fused rounding only in halfway cases)."""
    return (a.double() * b.double() + c.double()).float()


def norm3_f32(v):
    """|v| over the last axis of f32 [..., 3], rounded as
    ``jnp.linalg.norm`` rounds on XLA: sqrt(fma(z, z, fma(y, y, x·x))).
    The square root is taken in f64 and rounded to f32 (correctly
    rounded; torch's f32 ``sqrt`` on the CPU is not, in ~0.7% of
    values)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.sqrt(fma_f32(z, z, fma_f32(y, y, x * x)).double()).float()
