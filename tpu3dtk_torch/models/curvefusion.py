"""Trajectory curve fusion — the port of ``tpu3dtk.models.curvefusion``
(ref src/curvefusion/: curves.cc pairs a laser/odometry trajectory with
a GPS/ground-truth trajectory per timestamp, fusion.cc aligns and
blends them into one consistent curve via per-segment Eigen SVD
alignments).

- :func:`associate_by_time`: a numpy copy (host, f64).
- The per-window rigid alignments are one ``torch.func.vmap`` of the
  port's ``minimizers.pair_stats`` and ``MINIMIZERS["quat"]`` over an
  ``[S, W, 3]`` batch of windows on the device, with the inputs cast to
  f32 as the JAX package casts them (``sum_d2`` stays f64).
- The blend is one ``index_add_`` over all windows in f64, in place of
  the JAX package's loop over windows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import minimizers as mz

__all__ = ["FusionParams", "associate_by_time", "fuse_trajectories"]


@dataclasses.dataclass
class FusionParams:
    window: int = 8        # poses per alignment segment
    stride: int = 4        # segment stride
    blend: float = 0.5     # 0 = keep curve A, 1 = snap to curve B


def associate_by_time(t_a, t_b):
    """Index into ``t_b`` nearest each ``t_a`` (the per-timestamp curve
    pairing of curves.cc).  Both must be sorted ascending."""
    t_a = np.asarray(t_a, np.float64)
    t_b = np.asarray(t_b, np.float64)
    pos = np.searchsorted(t_b, t_a)
    lo = np.clip(pos - 1, 0, len(t_b) - 1)
    hi = np.clip(pos, 0, len(t_b) - 1)
    pick_hi = np.abs(t_b[hi] - t_a) < np.abs(t_b[lo] - t_a)
    return np.where(pick_hi, hi, lo)


def _window_index(N: int, window: int, stride: int):
    starts = np.arange(0, max(N - window + 1, 1), stride)
    idx = starts[:, None] + np.arange(window)[None, :]
    return starts, idx


def _one_align(a, b):
    stats = mz.pair_stats(b, a, torch.ones(a.shape[0], dtype=torch.bool, device=a.device))
    return mz.MINIMIZERS["quat"](stats)


def _segment_aligns(pa, pb, window, stride, device):
    """Rigid alignments taking curve-A windows onto curve B: one batched
    Horn solve over every window on ``device``.  ``pa``/``pb``: [N,3] f64
    tensors there.  Returns (starts, aligns [S,4,4] f64, errs [S] f64)."""
    N = pa.shape[0]
    starts, idx = _window_index(N, window, stride)
    idx_t = torch.as_tensor(np.minimum(idx, N - 1), device=device)
    A = pa[idx_t].to(torch.float32)  # [S, W, 3]
    B = pb[idx_t].to(torch.float32)
    aligns, errs = torch.func.vmap(_one_align)(A, B)
    return starts, aligns.to(torch.float64), errs


def fuse_trajectories(t_a, pos_a, t_b, pos_b, params: FusionParams | None = None, device=None):
    """Fuse trajectory A (dense, drifting — laser odometry) with
    trajectory B (sparse/noisy but globally correct — GPS/ground
    truth).  Returns (fused [N,3] at A's timestamps, info dict), as
    numpy.  Runs on ``device`` (None: the first CUDA card).

    Pipeline (fusion.cc): associate by time → per-window rigid
    alignments of A onto B → blend each A position between its raw and
    segment-aligned location with distance-weighted smooth weights.
    """
    params = params or FusionParams()
    if device is None:
        from .. import default_device

        device = default_device()
    dev = torch.device(device)
    pos_a = np.asarray(pos_a, np.float64)
    pos_b = np.asarray(pos_b, np.float64)
    j = associate_by_time(t_a, t_b)
    pa = torch.as_tensor(pos_a, device=dev)
    pb = torch.as_tensor(pos_b[j], device=dev)
    W = params.window
    starts, aligns, errs = _segment_aligns(pa, pb, W, params.stride, dev)
    N = pos_a.shape[0]
    _, idx = _window_index(N, W, params.stride)
    # triangular weight toward each segment's centre; rows past the end
    # (a window clipped at N) add nothing
    k = torch.as_tensor(idx, device=dev)
    inside = k < N
    kc = torch.clamp(k, max=N - 1)
    centre = torch.as_tensor(starts + W / 2.0, device=dev)
    w = torch.clamp(1.0 - (k.to(torch.float64) - centre[:, None]).abs() / W, min=1e-3)
    w = torch.where(inside, w, 0.0)
    moved = pa[kc] @ aligns[:, :3, :3].transpose(1, 2) + aligns[:, None, :3, 3]
    acc = torch.zeros((N, 3), dtype=torch.float64, device=dev)
    wacc = torch.zeros(N, dtype=torch.float64, device=dev)
    acc.index_add_(0, kc.reshape(-1), (w[..., None] * moved).reshape(-1, 3))
    wacc.index_add_(0, kc.reshape(-1), w.reshape(-1))
    aligned = torch.where(
        wacc[:, None] > 0, acc / torch.clamp(wacc, min=1e-12)[:, None], pa
    )
    fused = ((1.0 - params.blend) * aligned + params.blend * pb).cpu().numpy()
    pbn = pos_b[j]
    rmse_before = float(np.sqrt(((pos_a - pbn) ** 2).sum(1).mean()))
    rmse_after = float(np.sqrt(((fused - pbn) ** 2).sum(1).mean()))
    return fused, {
        "segments": len(starts),
        "rmse_before": rmse_before,
        "rmse_after": rmse_after,
        "segment_errors": errs.cpu().numpy(),
        "segment_aligns": aligns.cpu().numpy(),
    }
