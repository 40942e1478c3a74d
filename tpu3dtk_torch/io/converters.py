"""Trajectory / pose format converters — the reference's converter tool
family (src/slam6d/: frames2pose, pose2frames, frames2kitti, kitti2pose,
frames2riegl, riegl2frames, frames2tum, trajectoryLength, toGlobal;
SURVEY §2.1 'converters' row).

All converters operate on the standard (4,4) pose layout and use the
column-major 16-vector only at file boundaries.

The port of ``tpu3dtk.io.converters``.  The trajectory converters are
host numpy, as there.  What the JAX package runs on its device runs on
the card here (or on the device the caller names): ``scan_diff`` and
``scan_diff2d`` rank on the brute NN (K1, ``ops.nn_cuda``, through a
model prepared once), ``sicp_align`` reduces its pairs with the port's
``models.minimizers`` (f32 statistics, as the JAX package casts them;
the rotation projected onto SO(3) in f64 on the host) and
``scan_to_features`` reduces and takes k-NN normals with ``core.scan``
and ``ops.normals``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import math3d
from . import frames as frames_io
from .formats import get_format

__all__ = [
    "frames_to_pose",
    "pose_to_frames",
    "matrix_to_kitti",
    "kitti_to_matrix",
    "frames_to_kitti",
    "kitti_to_poses",
    "frames_to_tum",
    "trajectory_length",
    "ate",
    "nearest_orthonormal",
    "average_pose_matrices",
    "transform_frames",
    "mult_frames",
    "frames_to_riegl",
    "riegl_to_frames",
    "registered_points",
    "scan_diff",
    "scan_diff_found",
    "scan_diff2d",
    "sicp_align",
    "scan_to_features",
    "frames_to_graph",
    "convergence_trace",
]

# kitti frame = sign conjugation D·T·D (D = diag(1,-1,1,1)) + cm -> m
# (ref frames2kitti.cc:116-135)
_D = np.diag([1.0, -1.0, 1.0, 1.0])


def matrix_to_kitti(T: np.ndarray) -> np.ndarray:
    """3DTK pose (4,4), cm -> KITTI 12-vector (row-major [R|t] in m)."""
    K = _D @ np.asarray(T, np.float64) @ _D
    K = K.copy()
    K[:3, 3] /= 100.0
    return K[:3, :4].reshape(12)


def kitti_to_matrix(row: np.ndarray) -> np.ndarray:
    """KITTI 12-vector -> 3DTK pose (4,4) in cm."""
    K = np.eye(4)
    K[:3, :4] = np.asarray(row, np.float64).reshape(3, 4)
    K[:3, 3] *= 100.0
    return _D @ K @ _D


def frames_to_pose(directory: str, out_dir: str | None = None) -> int:
    """Write scanXXX.pose from the final pose of each scanXXX.frames
    (ref frames2pose.cc)."""
    from .writer import write_pose

    out_dir = out_dir or directory
    count = 0
    for fn in sorted(os.listdir(directory)):
        if not fn.endswith(".frames"):
            continue
        ident = fn[: -len(".frames")]
        T = frames_io.final_pose(os.path.join(directory, fn))
        theta, pos = math3d.matrix4_to_euler(T)
        write_pose(os.path.join(out_dir, f"{ident}.pose"), np.asarray(pos), np.asarray(theta))
        count += 1
    return count


def pose_to_frames(directory: str, out_dir: str | None = None) -> int:
    """Write a one-line scanXXX.frames from each scanXXX.pose (ref
    pose2frames.cc)."""
    from .scandir import read_pose_file

    out_dir = out_dir or directory
    count = 0
    for fn in sorted(os.listdir(directory)):
        if not fn.endswith(".pose"):
            continue
        ident = fn[: -len(".pose")]
        pos, theta = read_pose_file(os.path.join(directory, fn))
        T = np.asarray(math3d.euler_to_matrix4(pos, theta))
        frames_io.write_frames(
            os.path.join(out_dir, f"{ident}.frames"),
            T[None],
            [frames_io.AlgoType.ICP],
        )
        count += 1
    return count


def frames_to_kitti(directory: str, out_path: str) -> int:
    """Final poses of all .frames -> one KITTI trajectory file (one
    12-value row per scan, ref frames2kitti.cc)."""
    rows = []
    for fn in sorted(os.listdir(directory)):
        if fn.endswith(".frames"):
            rows.append(matrix_to_kitti(frames_io.final_pose(os.path.join(directory, fn))))
    np.savetxt(out_path, np.asarray(rows), fmt="%.9g")
    return len(rows)


def kitti_to_poses(kitti_path: str, out_dir: str) -> int:
    """KITTI trajectory file -> scanXXX.pose files (ref kitti2pose.cc)."""
    from .writer import write_pose

    os.makedirs(out_dir, exist_ok=True)
    rows = np.loadtxt(kitti_path, ndmin=2)
    for i, row in enumerate(rows):
        T = kitti_to_matrix(row)
        theta, pos = math3d.matrix4_to_euler(T)
        write_pose(
            os.path.join(out_dir, f"scan{i:03d}.pose"), np.asarray(pos), np.asarray(theta)
        )
    return len(rows)


def frames_to_tum(directory: str, out_path: str, dt: float = 1.0) -> int:
    """Final poses -> TUM trajectory (t tx ty tz qx qy qz qw, metres;
    ref frames2tum.cc)."""
    lines = []
    i = 0
    for fn in sorted(os.listdir(directory)):
        if not fn.endswith(".frames"):
            continue
        T = frames_io.final_pose(os.path.join(directory, fn))
        q = np.asarray(math3d.matrix4_to_quat(T))  # [w,x,y,z]
        t = T[:3, 3] / 100.0
        lines.append(
            f"{i * dt:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}"
        )
        i += 1
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return i


def trajectory_length(directory: str) -> float:
    """Sum of distances between consecutive final poses (ref
    trajectoryLength.cc), in cm."""
    poses = []
    for fn in sorted(os.listdir(directory)):
        if fn.endswith(".frames"):
            poses.append(frames_io.final_pose(os.path.join(directory, fn))[:3, 3])
    if len(poses) < 2:
        return 0.0
    p = np.asarray(poses)
    return float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum())


def ate(frames_dir_a: str, frames_dir_b: str, align: bool = True):
    """Absolute trajectory error between two .frames directories — the
    evaluation role of match_with_ground_truth.cc.

    Returns dict with rmse/mean/max position error (cm) after optional
    Horn alignment of trajectory a onto b.
    """
    def load(d):
        out = {}
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".frames"):
                out[fn] = frames_io.final_pose(os.path.join(d, fn))[:3, 3]
        return out

    A = load(frames_dir_a)
    B = load(frames_dir_b)
    common = sorted(set(A) & set(B))
    if not common:
        raise ValueError("no common .frames identifiers")
    pa = np.asarray([A[k] for k in common])
    pb = np.asarray([B[k] for k in common])
    if align and len(common) >= 3:
        ca, cb = pa.mean(0), pb.mean(0)
        H = (pb - cb).T @ (pa - ca)
        U, _, Vt = np.linalg.svd(H)
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
        R = U @ D @ Vt
        pa = (pa - ca) @ R.T + cb
    err = np.linalg.norm(pa - pb, axis=1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "max": float(err.max()),
        "n": len(common),
    }


def nearest_orthonormal(M: np.ndarray) -> np.ndarray:
    """Nearest rotation matrix to M in Frobenius norm.  The reference
    computes M·(MᵀM)^(-1/2) via the eigen-decomposition of MᵀM
    (average6DoFposes.cc:109-150); the polar factor UVᵀ of the SVD is the
    same matrix, in one primitive."""
    U, _, Vt = np.linalg.svd(np.asarray(M, np.float64))
    R = U @ Vt
    if np.linalg.det(R) < 0:  # keep a proper rotation
        U[:, -1] = -U[:, -1]
        R = U @ Vt
    return R


def average_pose_matrices(mats) -> np.ndarray:
    """Average a set of 4x4 pose matrices: element-wise mean, then project
    the rotation block onto SO(3) (ref average6DoFposes.cc:95-160)."""
    A = np.mean([np.asarray(m, np.float64) for m in mats], axis=0)
    out = np.eye(4)
    out[:3, :3] = nearest_orthonormal(A[:3, :3])
    out[:3, 3] = A[:3, 3]
    return out


def _frames_files(directory: str) -> list[str]:
    return sorted(f for f in os.listdir(directory) if f.endswith(".frames"))


def transform_frames(directory: str, T: np.ndarray, out_dir: str | None = None) -> int:
    """Left-multiply every entry of every .frames file by the fixed 4x4 T
    (ref transformFrames.cc: applies a global alignment found from point
    pairs to a registered sequence)."""
    out_dir = out_dir or directory
    T = np.asarray(T, np.float64)
    count = 0
    for fn in _frames_files(directory):
        mats, tags = frames_io.read_frames(os.path.join(directory, fn))
        new = np.einsum("ij,njk->nik", T, mats)
        frames_io.write_frames(os.path.join(out_dir, fn), new, tags)
        count += 1
    return count


def mult_frames(
    directory: str,
    matrix: np.ndarray,
    out_dir: str,
    anchor: int = 0,
    from_pose: bool = False,
    prefix: str = "scan",
) -> int:
    """Re-anchor a registered sequence: given `matrix` mapping the anchor
    scan's own frame into a global frame, write new .frames holding
    matrix · anchor_pose⁻¹ · scan_pose for every scan
    (ref multFrames.cc:222-280)."""
    from .scandir import read_pose_file

    def load(ident: str) -> np.ndarray:
        if from_pose:
            pos, theta = read_pose_file(
                os.path.join(directory, f"{prefix}{ident}.pose")
            )
            return np.asarray(math3d.euler_to_matrix4(pos, theta))
        return frames_io.final_pose(
            os.path.join(directory, f"{prefix}{ident}.frames")
        )

    suffix = ".pose" if from_pose else ".frames"
    idents = sorted(
        fn[len(prefix) : -len(suffix)]
        for fn in os.listdir(directory)
        if fn.startswith(prefix) and fn.endswith(suffix)
    )
    anchor_T = load(f"{anchor:03d}" if f"{anchor:03d}" in idents else idents[anchor])
    corr = np.asarray(matrix, np.float64) @ np.asarray(
        math3d.m4inv(anchor_T), np.float64
    )
    os.makedirs(out_dir, exist_ok=True)
    for ident in idents:
        T = corr @ load(ident)
        # reference writeFrames repeats the final matrix 3x with tag 2
        # (multFrames.cc:200-213) so `show` animates cleanly
        frames_io.write_frames(
            os.path.join(out_dir, f"{prefix}{ident}.frames"),
            np.repeat(T[None], 3, axis=0),
            np.full(3, 2, np.int64),
        )
    return len(idents)


def frames_to_riegl(directory: str, out_dir: str | None = None) -> int:
    """Write RIEGL .dat pose files (row-major 4x4, metres) from the final
    .frames matrices — the inverse axis remap of the riegl reader
    (ref frames2riegl.cc + globals.icc:471-494 toRieglMat)."""
    out_dir = out_dir or directory
    count = 0
    for fn in _frames_files(directory):
        t = np.asarray(math3d.to_colmajor16(frames_io.final_pose(os.path.join(directory, fn))), np.float64)
        o = np.empty(16)
        o[5], o[9], o[1], o[13] = t[0], -t[1], -t[2], -t[3]
        o[6], o[10], o[2], o[14] = -t[4], t[5], t[6], t[7]
        o[4], o[8], o[0], o[12] = -t[8], t[9], t[10], t[11]
        o[7], o[11], o[3], o[15] = -t[12], t[13], t[14], t[15]
        o[[3, 7, 11]] /= 100.0
        ident = fn[: -len(".frames")]
        np.savetxt(
            os.path.join(out_dir, f"{ident}.dat"), o.reshape(4, 4), fmt="%.9f"
        )
        count += 1
    return count


def riegl_to_frames(directory: str, out_dir: str | None = None) -> int:
    """Write one-line .frames from RIEGL .dat pose files (ref
    riegl2frames.cc)."""
    from .scandir import _read_pose_riegl

    out_dir = out_dir or directory
    count = 0
    for fn in sorted(os.listdir(directory)):
        if not fn.endswith(".dat"):
            continue
        pos, theta = _read_pose_riegl(os.path.join(directory, fn))
        T = np.asarray(math3d.euler_to_matrix4(pos, theta))
        ident = fn[: -len(".dat")]
        frames_io.write_frames(
            os.path.join(out_dir, f"{ident}.frames"), T[None], np.array([2])
        )
        count += 1
    return count


def _device(device) -> torch.device:
    """``device`` as a torch device; None: the package default (the first
    card; raises without one)."""
    if device is None:
        from .. import default_device

        return default_device()
    return torch.device(device)


def registered_points(directory: str, format: str, num: int, use_frames: bool = True) -> np.ndarray:
    """Scan ``num`` in the global frame (f64): its final .frames pose if
    asked for and present, else its .pose."""
    from .scandir import read_scan

    spec = get_format(format)
    scan = read_scan(directory, f"{num:03d}", spec)
    T = None
    if use_frames:
        fp = frames_io.frames_path(directory, f"{num:03d}", spec.data_prefix)
        if os.path.exists(fp):
            T = frames_io.final_pose(fp)
    if T is None:
        T = np.asarray(math3d.euler_to_matrix4(scan.pose_pos, scan.pose_theta))
    return np.asarray(math3d.transform3(T, scan.xyz))


def scan_diff_found(a: np.ndarray, b: np.ndarray, max_dist: float, device=None) -> np.ndarray:
    """For each point of ``b`` ([Q, 3] f32), whether a point of ``a``
    ([M, 3] f32) lies strictly within ``max_dist``: one brute NN call on
    ``device`` (K1 on a card) against ``a`` prepared once.  [Q] bool."""
    from ..ops import nn as nn_ops

    dev = _device(device)
    ta = torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    tb = torch.as_tensor(np.ascontiguousarray(b, np.float32), device=dev)
    model = nn_ops.prepare_brute_model(
        ta, torch.ones(len(ta), dtype=torch.bool, device=dev)
    )
    _, _, found = nn_ops.nn_brute_auto(
        tb, torch.ones(len(tb), dtype=torch.bool, device=dev), model, None,
        float(max_dist) ** 2,
    )
    return found.cpu().numpy()


def scan_diff(
    directory: str,
    format: str = "uos",
    id_a: int = 0,
    id_b: int = 1,
    max_dist: float = 50.0,
    use_frames: bool = True,
    device=None,
) -> np.ndarray:
    """Points of scan `id_b` (global frame) farther than `max_dist` from
    every point of scan `id_a` — the change/difference extraction of
    scan_diff.cc (NN threshold on registered scans).  Returns [K,3] f32.
    Both raw scans go to ``device`` (default: the first card) and are
    matched by :func:`scan_diff_found`."""
    a = registered_points(directory, format, id_a, use_frames).astype(np.float32)
    b = registered_points(directory, format, id_b, use_frames).astype(np.float32)
    return b[~scan_diff_found(a, b, max_dist, device)]


def frames_to_graph(
    directory: str, out_path: str, start: int = 0, end: int = -1
) -> int:
    """Final frame pose per scan -> one 'x y z qw qx qy qz' line each
    (ref src/slam6d/frame_to_graph.cc:38-66: position + quaternion of
    the last frames entry)."""
    count = 0
    with open(out_path, "w") as out:
        for name in _frames_files(directory):
            ident = name[len("scan"):-len(".frames")]
            try:
                num = int(ident)
            except ValueError:
                num = -1
            if num >= 0 and (num < start or (end >= 0 and num > end)):
                continue
            T = frames_io.final_pose(os.path.join(directory, name))
            _, pos = math3d.matrix4_to_euler(T)
            q = np.asarray(math3d.matrix4_to_quat(T))
            out.write(
                f"{pos[0]} {pos[1]} {pos[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n"
            )
            count += 1
    return count


def convergence_trace(
    directory: str, scan_id: int = 0, ctype: str = "global"
) -> np.ndarray:
    """Per-frame pose evolution of one scan — the convergence-graph data
    of src/slam6d/convergence.cc (-z 0 global = every frame, 1 local =
    ICP frames only).  Returns [F, 6] rows (pos, theta)."""
    path = frames_io.frames_path(directory, f"{scan_id:03d}")
    mats, types = frames_io.read_frames(path)
    rows = []
    for T, t in zip(mats, types):
        if ctype == "local" and int(t) != int(frames_io.AlgoType.ICP):
            continue
        theta, pos = math3d.matrix4_to_euler(T)
        rows.append(np.concatenate([np.asarray(pos), np.asarray(theta)]))
    return np.stack(rows) if rows else np.zeros((0, 6))


def sicp_align(
    global_pts: np.ndarray, local_pts: np.ndarray, n_use: int = -1,
    minimizer: str = "quat", device=None,
) -> np.ndarray:
    """Alignment from GIVEN correspondences — the sICP tool
    (src/slam6d/sICP.cc: matching with known pairs, no NN search).
    Row k of local_pts corresponds to row k of global_pts.  Returns the
    [4,4] transform taking local -> global.  The pairs are reduced in
    f32 on ``device`` (default: the first card), as the JAX package casts
    them; the rotation is projected onto SO(3) in f64 on the host."""
    from ..models import minimizers as mz

    a = np.asarray(global_pts, np.float64)
    b = np.asarray(local_pts, np.float64)
    if n_use > 0:
        a, b = a[:n_use], b[:n_use]
    if len(a) != len(b) or len(a) < 3:
        raise ValueError("need >= 3 correspondences of equal length")
    dev = _device(device)
    stats = mz.pair_stats(
        torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(b, dtype=torch.float32, device=dev),
        torch.ones(len(a), dtype=torch.bool, device=dev),
    )
    align, _err = mz.get_minimizer(minimizer)(stats)
    T = align.cpu().numpy().astype(np.float64)
    T[:3, :3] = nearest_orthonormal(T[:3, :3])
    return T


def scan_diff2d(
    directory: str,
    out_png: str,
    format: str = "uos",
    id_a: int = 0,
    id_b: int = 1,
    max_dist: float = 50.0,
    width: int = 800,
    device=None,
) -> np.ndarray:
    """Color-coded top-down 2D difference image of two registered scans
    (ref src/slam6d/scan_diff2d.cc): gray = scan A footprint, red =
    points of B not explained by A within max_dist.  Writes a PNG and
    returns the image array.  As in the JAX package, scan A is read here
    and both scans again by :func:`scan_diff` (on ``device``)."""
    from .png import write_png

    a = registered_points(directory, format, id_a, True)
    diff = scan_diff(directory, format, id_a, id_b, max_dist, device=device)
    both = np.concatenate([a, diff]) if len(diff) else a
    lo = both[:, [0, 2]].min(0)
    hi = both[:, [0, 2]].max(0)
    span = np.maximum(hi - lo, 1e-6)
    height = max(int(width * span[1] / span[0]), 1)

    def rasterize(pts):
        uv = (pts[:, [0, 2]] - lo) / span
        u = np.clip((uv[:, 0] * (width - 1)).astype(int), 0, width - 1)
        v = np.clip((uv[:, 1] * (height - 1)).astype(int), 0, height - 1)
        img = np.zeros((height, width), bool)
        img[v, u] = True
        return img

    img = np.zeros((height, width, 3), np.uint8)
    img[rasterize(a)] = (160, 160, 160)
    if len(diff):
        img[rasterize(diff)] = (255, 32, 32)
    write_png(out_png, img)
    return img


def scan_to_features(
    directory: str,
    out_dir: str | None = None,
    format: str = "uos",
    reduce_voxel: float = 10.0,
    k: int = 20,
    device=None,
) -> int:
    """Per-point feature files — the scan2features tool
    (src/slam6d/scan2features.cc): for each (reduced) point write
    'x y z nx ny nz curvature' where the normal and the surface-
    variation curvature come from the local KNN PCA
    (ops.normals).  Writes scanNNN.feat per scan; returns scan count.
    Reduction and normals run on ``device`` (default: the first card);
    the random reduction (``reduce_voxel`` > 0, one point a voxel)
    draws from a CPU ``torch.Generator``, not ``jax.random``."""
    from ..core.scan import Scan
    from ..ops.normals import knn_pca_features
    from .scandir import read_scan_dir

    dev = _device(device)
    out_dir = out_dir or directory
    count = 0
    for raw in read_scan_dir(directory, format=format):
        s = Scan.from_raw(raw, device=dev)
        s.set_reduction(reduce_voxel, 1 if reduce_voxel > 0 else 0)
        pts = np.asarray(s.reduced_local())
        normals, curvature = knn_pca_features(pts, k=k, device=dev)
        with open(
            os.path.join(out_dir, f"scan{s.identifier}.feat"), "w"
        ) as f:
            for p, n, c in zip(pts, normals, curvature):
                f.write(
                    f"{p[0]} {p[1]} {p[2]} {n[0]} {n[1]} {n[2]} {c}\n"
                )
        count += 1
    return count
