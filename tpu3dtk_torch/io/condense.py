"""condense / atomize: metascan merge and re-split with frames reapply.

Re-implements the reference pair of tools (src/slam6d/condense.cc:163-250,
src/slam6d/atomize.cc:126-165):

- ``condense``: groups of `split` consecutive scans are merged into one
  scan file each (points expressed in the group anchor's frame — the
  first scan of the group, ref condense.cc:218-232 `ref = 0`), written to
  ``<dir>/cond/scanNNN.{3d,pose}``.  SLAM then runs on the (much shorter)
  condensed sequence.
- ``atomize``: per condensed group, the correction
  ``rel = cond_frames_final · cond_pose⁻¹`` (atomize.cc:133-139) is
  applied to every original scan's initial pose ``transMatOrg`` and
  written back as per-scan .frames (atomize.cc:142-163).

The port of ``tpu3dtk.io.condense``: the voxel reduction of a metascan
(``voxel`` > 0, centre mode) runs on ``device`` (default: the first
card) through ``ops.reduction.voxel_reduce``; the rest is host numpy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import math3d
from ..ops.reduction import voxel_reduce
from . import frames as frames_io
from .scandir import PointFilter, read_scan_dir
from .writer import write_pose, write_uos

__all__ = ["condense", "atomize"]


def _pose_matrix(raw) -> np.ndarray:
    return np.asarray(math3d.euler_to_matrix4(raw.pose_pos, raw.pose_theta))


def condense(
    directory: str,
    format: str = "uos",
    split: int = 10,
    start: int = 0,
    end: int = -1,
    voxel: float = -1.0,
    out_dir: str | None = None,
    max_range: float = -1.0,
    use_frames: bool = False,
    device=None,
) -> int:
    """Merge every `split` scans into one condensed scan; returns the
    number of condensed files written.  With ``voxel`` > 0 each metascan
    is reduced to voxel centres on ``device`` (default: the first card)."""
    dev = None
    if voxel > 0:
        from .. import default_device

        dev = default_device() if device is None else torch.device(device)
    out_dir = out_dir or os.path.join(directory, "cond")
    os.makedirs(out_dir, exist_ok=True)
    pf = PointFilter(range_max=max_range if max_range > 0 else None)
    group_pts: list[np.ndarray] = []
    anchor_inv = None
    anchor_pose = None
    seq = 0

    def flush():
        nonlocal seq, group_pts
        if not group_pts:
            return
        pts = np.concatenate(group_pts, axis=0)
        if voxel > 0:
            t = torch.as_tensor(pts.astype(np.float32), device=dev)
            out, keep = voxel_reduce(
                t, torch.ones(len(t), dtype=torch.bool, device=dev), voxel
            )
            pts = out[keep].cpu().numpy()
        write_uos(os.path.join(out_dir, f"scan{seq:03d}.3d"), pts)
        theta, pos = math3d.matrix4_to_euler(anchor_pose)
        write_pose(
            os.path.join(out_dir, f"scan{seq:03d}.pose"),
            np.asarray(pos),
            np.asarray(theta),
        )
        seq += 1
        group_pts = []

    k = 0
    for raw in read_scan_dir(directory, format, start, end, pf):
        T = _pose_matrix(raw)
        if use_frames:
            fp = frames_io.frames_path(directory, raw.identifier)
            if os.path.exists(fp):
                T = frames_io.final_pose(fp)
        if k == 0:
            anchor_pose = T
            anchor_inv = np.asarray(math3d.m4inv(T))
        # express points in the anchor scan's frame (condense.cc ref=0)
        rel = anchor_inv @ T
        group_pts.append(np.asarray(math3d.transform3(rel, raw.xyz)))
        k += 1
        if k == split:
            flush()
            k = 0
    flush()
    return seq


def atomize(
    cond_dir: str,
    orig_dir: str,
    format: str = "uos",
    split: int = 10,
    start: int = 0,
    end: int = -1,
) -> int:
    """Distribute condensed-sequence SLAM corrections back onto the
    original scans' .frames; returns scans written."""
    from .scandir import get_format, list_identifiers, read_pose_file

    spec = get_format(format)
    idents = list_identifiers(orig_dir, spec, start, end)
    count = 0
    rel = np.eye(4)
    for i, ident in enumerate(idents):
        seq = i // split
        if i % split == 0:
            cond_pose_p = os.path.join(cond_dir, f"scan{seq:03d}.pose")
            pos, theta = read_pose_file(cond_pose_p)
            cond_pose = np.asarray(math3d.euler_to_matrix4(pos, theta))
            cond_T = frames_io.final_pose(
                os.path.join(cond_dir, f"scan{seq:03d}.frames")
            )
            rel = cond_T @ np.asarray(math3d.m4inv(cond_pose))
        pos, theta = read_pose_file(
            os.path.join(orig_dir, f"{spec.pose_prefix}{ident}{spec.pose_suffix}")
        )
        T_org = np.asarray(math3d.euler_to_matrix4(pos, theta))
        T_out = rel @ T_org
        frames_io.write_frames(
            frames_io.frames_path(orig_dir, ident, spec.data_prefix),
            np.repeat(T_out[None], 3, axis=0),
            np.full(3, 2, np.int64),
        )
        count += 1
    return count
