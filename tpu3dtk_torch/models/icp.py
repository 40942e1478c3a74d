"""ICP matching engine — the port of ``tpu3dtk.models.icp`` (the
reference's ``icp6D``, src/slam6d/icp6D.cc:104-285).

Each iteration, on the device of the clouds:

  1. transform the target points by the current pose (local points stay
     immutable; the pose is composed instead),
  2. nearest neighbours against the model, prepared once per match
     (``ops.nn.prepare_brute_model``, ``ops.nn.nn_brute_auto``: the CUDA
     kernel on a card, the plain version on the CPU),
  3. masked centred pair statistics (ref icp6D.cc:144-191),
  4. a closed-form minimizer (``models.minimizers``),
  5. pose update T <- align @ T (ref transformMatrix, scan.cc:878-898),
  6. the stop tests of the JAX package: the two-delta test
     |err - prev| < eps and |err - prevprev| < eps (ref
     icp6D.cc:266-279) on an f64 error, the pose-fixpoint test and
     n ≤ 3 pairs.

The JAX package runs this as one ``lax.while_loop``; here it is a Python
loop that reads four scalars back from the device once per iteration
for the stop tests.  :func:`icp_pair_chained` is the second engine, for
large models: nearest neighbours through the cell-list chain (kernel K2,
``ops.nn_cell_list``), the stop tests evaluated on the device and read
back every fourth iteration.  Pairing semantics match ``SearchTree::getPtPairs``
(src/slam6d/searchTree.cc:91-188): model points in the model's current
global frame, target points in the target's current estimate, matches
at or beyond max_dist_match2 rejected.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import math3d
from ..ops import nn as nn_ops
from ..utils.metrics import metrics
from . import minimizers as mz

__all__ = [
    "IcpParams", "IcpResult", "icp_pair", "icp_pair_chained", "icp_pair_seq",
    "icp_window_align", "register_sequence_device",
]

# metrics counter: loop trips of the chained engine (one cell-list NN
# call each; the reported iterations stop counting once a match is done)
CHAINED_TRIPS = "chained_icp_loop_trips"

# pose-fixpoint thresholds of the JAX package (f32 values): an increment
# below 100 um / ~1e-5 rad is the f32 stats-noise floor
_POSE_T = float(np.float32(1e-2))
_POSE_R = float(np.float32(1e-5))


class IcpParams(NamedTuple):
    max_dist_match2: float = 625.0  # -d 25 -> 25^2 (cm^2)
    max_iterations: int = 50  # -i
    epsilon: float = 1e-5  # --epsICP
    minimizer: str = "quat"  # -a
    subsample: int = 1  # -R: take ~1/rnd of target points per iteration
    pairing: str = "closest_point"  # ref PairingMode; only this one is ported


class IcpResult(NamedTuple):
    T: torch.Tensor  # [4,4] f32 final pose of the target scan (global)
    error: float  # final RMS point-to-point error (f64)
    iterations: int  # iterations executed
    n_pairs: float  # pairs in the last iteration
    # chained engine only: > 0 when a cell-list exactness guard fired
    # (lane overflow or a point outside the grid box) and the caller
    # must redo the match with the brute engine
    maxocc: int = 0


def _find_pairs(bm: nn_ops.BruteModel, tgt_global, tmask, max_dist2):
    """Closest-point correspondences for one iteration against the
    prepared model: matched model points [N,3] and the accept mask [N]."""
    idx, _d2, found = nn_ops.nn_brute_auto(
        tgt_global, tmask, bm, None, max_dist2
    )
    return bm.model[idx], found


def icp_pair(
    model, mmask, target_local, tmask, T0, *,
    max_dist_match2, epsilon,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    seed: int = 0,
    pairing: str = "closest_point",
) -> IcpResult:
    """Match one target scan against fixed model points.

    model: [M,3] f32 model points in the global frame; target_local:
    [N,3] f32 target points in the target's **local** frame; masks bool;
    T0: [4,4] initial global pose of the target.  All on one device.

    ``subsample`` = the reference's ``rnd`` (-R): each iteration keeps a
    fresh ~1/subsample random subset of the target points
    (searchTree.cc:54-55), drawn from a CPU ``torch.Generator`` seeded
    with ``seed`` (the JAX package draws from ``jax.random``).
    """
    if pairing != "closest_point":
        raise NotImplementedError(
            f"pairing {pairing!r} is not ported yet (ROADMAP A12: "
            "normals-based pairing)"
        )
    align_fn = mz.get_minimizer(minimizer)
    dev = model.device
    # the model is fixed for the whole match: centred and packed once
    bm = nn_ops.prepare_brute_model(model.to(torch.float32).contiguous(), mmask)
    target_local = target_local.to(torch.float32)
    T = torch.as_tensor(T0, dtype=torch.float32, device=dev)
    eps = float(np.float32(epsilon))
    md2 = float(np.float32(max_dist_match2))
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(int(seed)) if subsample > 1 else None

    ret = prev = prev2 = 0.0
    npairs = 0.0
    it = 0
    done = False
    while not done and it < max_iterations:
        it_mask = tmask
        if gen is not None:
            keep = torch.randint(0, subsample, tmask.shape, generator=gen) == 0
            it_mask = tmask & keep.to(dev)
        tgt_global = math3d.transform3(T, target_local)
        m_pts, found = _find_pairs(bm, tgt_global, it_mask, md2)
        stats = mz.pair_stats(m_pts, tgt_global, found)
        align, err = align_fn(stats)
        # the one device->host read of the iteration
        n, err_v, tnorm, rnorm = torch.stack([
            stats.n.double(),
            err.double(),
            torch.linalg.norm(align[:3, 3]).double(),
            torch.linalg.norm(align[:3, :3] - eye4[:3, :3]).double(),
        ]).tolist()
        enough = n > 3
        if enough:
            T = align @ T
        prev2, prev = prev, ret
        if enough:
            ret = err_v
        conv = abs(ret - prev) < eps and abs(ret - prev2) < eps
        pose_conv = tnorm < _POSE_T and rnorm < _POSE_R
        done = conv or (pose_conv and enough) or not enough
        npairs = n
        it += 1
    return IcpResult(T=T, error=ret, iterations=it, n_pairs=npairs)


def _window(locals_all, masks_all, mats, lo: int, hi: int, window_cap: int,
            n_real: int | None = None):
    """Window of whole scans from the sequence-resident tensors: scans
    [lo, hi) (and below ``n_real``, where given) of the
    ``window_cap``-scan slice starting at clip(lo, 0, S - W),
    transformed by their current poses ([W*N, 3], [W*N]); the other
    scans of the slice are masked out.  Serves the metascan model of the
    sequential matches and the loop-closure windows."""
    S, N = masks_all.shape
    W = min(window_cap, S) if window_cap else S
    s0 = min(max(lo, 0), S - W)
    win_locals = locals_all[s0 : s0 + W]
    win_mats = mats[s0 : s0 + W]
    pts_g = (
        torch.einsum("sij,snj->sni", win_mats[:, :3, :3], win_locals)
        + win_mats[:, None, :3, 3]
    )
    hi = hi if n_real is None else min(hi, n_real)
    sid = torch.arange(s0, s0 + W, device=masks_all.device)
    active = (sid >= lo) & (sid < hi)
    mmask = (masks_all[s0 : s0 + W] & active[:, None]).reshape(W * N)
    return pts_g.reshape(W * N, 3), mmask


def icp_pair_seq(
    locals_all, masks_all, mats, lo: int, hi: int, tgt_idx: int, T0,
    max_dist_match2, epsilon, seed: int = 0, *,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    pairing: str = "closest_point",
    window_cap: int = 0,
) -> IcpResult:
    """Sequence-resident match: the model is built on the device from the
    resident [S, N, 3] local points and the current poses ``mats``
    [S, 4, 4] (scans [lo, hi) of a ``window_cap``-scan window, 0 = all),
    and scan ``tgt_idx`` is matched against it from pose ``T0``."""
    model, mmask = _window(locals_all, masks_all, mats, lo, hi, window_cap)
    return icp_pair(
        model, mmask, locals_all[tgt_idx], masks_all[tgt_idx], T0,
        max_dist_match2=max_dist_match2, epsilon=epsilon,
        max_iterations=max_iterations, minimizer=minimizer,
        subsample=subsample, seed=seed, pairing=pairing,
    )


def _window_build(
    locals_all, masks_all, mats, m_lo: int, m_hi: int, t_lo: int, t_hi: int,
    n_real: int, *, wm: int, wt: int,
):
    """ELCH loop-closure windows from the RESIDENT sequence tensors:
    model = scans [m_lo, m_hi] and target = scans [t_lo, t_hi]
    (inclusive, clipped to [0, n_real)), both in the global frame, as
    windows of ``wm`` / ``wt`` whole scans (5 and 3 in the reference,
    elch6Dslerp.cc:93-110) with the scans outside the range masked out."""
    model, mmask = _window(locals_all, masks_all, mats, m_lo, m_hi + 1, wm, n_real)
    tgt, tmask = _window(locals_all, masks_all, mats, t_lo, t_hi + 1, wt, n_real)
    return model, mmask, tgt, tmask


def icp_window_align(
    locals_all, masks_all, mats, first: int, last: int, n_real: int,
    max_dist_match2, epsilon,
    *,
    max_iterations: int = 50,
    minimizer: str = "quat",
    wm: int = 5,
    wt: int = 3,
) -> IcpResult:
    """ELCH loop-closure match: metascan(first±2) as model vs
    metascan(last-2..last) as target, both already in global frames, so
    T0 = identity and the result ``T`` is the loop-closing ``align``
    (elch6D*.cc my_icp6D->match(start, end))."""
    model, mmask, tgt, tmask = _window_build(
        locals_all, masks_all, mats,
        first - (wm - 1) // 2, first + (wm - 1) // 2, last - (wt - 1), last,
        n_real, wm=wm, wt=wt,
    )
    return icp_pair(
        model.contiguous(), mmask, tgt.contiguous(), tmask,
        torch.eye(4, dtype=torch.float32, device=model.device),
        max_dist_match2=max_dist_match2, epsilon=epsilon,
        max_iterations=max_iterations, minimizer=minimizer,
    )


def _chain_transform(T, target_local):
    return math3d.transform3(T, target_local).to(torch.float32)


def _chain_update_conv(model, idx, found, tgt_global, T, conv, eps, align_fn):
    """One chained-ICP update with the ON-DEVICE two-delta convergence
    state ``conv`` = (err, prev, prev2, done, n_iters): once done, the
    pose freezes (align = I) so queued iterations become no-ops and the
    host polls the done flag sparsely while iteration-granular
    convergence still takes effect (icp6D.cc:266-279).  Counterpart:
    ``tpu3dtk/models/icp.py::_chain_update_conv``."""
    err_prev, prev, _prev2, done, n_it = conv
    stats = mz.pair_stats(model[idx], tgt_global, found)
    enough = stats.n > 3
    align, err = align_fn(stats)
    active = enough & ~done
    eye4 = torch.eye(4, dtype=torch.float32, device=T.device)
    align = torch.where(active, align, eye4)
    T_new = align @ T
    conv_now = ((err - err_prev).abs() < eps) & ((err - prev).abs() < eps)
    # pose-fixpoint test (see icp_pair): increments at the f32 noise
    # floor (<100 um) make no further progress — stop
    pose_conv = (torch.linalg.norm(align[:3, 3]) < _POSE_T) & (
        torch.linalg.norm(align[:3, :3] - eye4[:3, :3]) < _POSE_R
    )
    done_new = done | conv_now | (pose_conv & active) | ~enough
    n_new = n_it + (~done).to(torch.int32)
    return T_new, (err, err_prev, prev, done_new, n_new), stats.n


def icp_pair_chained(
    model, mmask, target_local, tmask, T0, *,
    max_dist_match2, epsilon,
    max_iterations: int = 50,
    minimizer: str = "quat",
    spec=None,
    check_every: int = 4,
) -> IcpResult:
    """ICP for LARGE models through the cell-list chain (kernel K2) —
    the port of ``tpu3dtk/models/icp.py::icp_pair_chained``.

    Each iteration is a chain of device ops (transform, device query
    plan, cell-list kernel, pair statistics and update) with no host
    read inside: the two-delta convergence test runs ON DEVICE every
    iteration (the pose freezes once converged) and the host polls the
    done flag only every ``check_every`` iterations, so the
    per-iteration NN cost is O(Q · occupancy) instead of O(Q · M).

    Exactness guards: the per-iteration out-of-grid-box scalars (and
    the lane-overflow scalar, constantly false on the unclamped route
    taken here) accumulate on the device; if one fired, the caller must
    redo the match with the brute engine (returned via ``maxocc`` > 0).
    ``spec`` comes from ``ops.nn_cell_list.cell_list_spec``; without one
    it is sized over the model, and the brute engine runs when no spec
    fits.
    """
    from ..ops import nn_cell_list as ncl

    align_fn = mz.get_minimizer(minimizer)
    dev = model.device
    model = model.to(torch.float32).contiguous()
    target_local = target_local.to(torch.float32)
    T = torch.as_tensor(T0, dtype=torch.float32, device=dev)
    max_dist = float(np.sqrt(max_dist_match2))
    if spec is None:
        spec = ncl.cell_list_spec(model[mmask].cpu().numpy(), max_dist)
    if spec is None:
        return icp_pair(
            model, mmask, target_local, tmask, T,
            max_dist_match2=max_dist_match2, epsilon=epsilon,
            max_iterations=max_iterations, minimizer=minimizer,
        )
    perm = tuple(spec.get("perm", (0, 1, 2)))
    clm, oob_m = ncl.build_cell_list_model(
        model, mmask, spec["origin"], max_dist,
        dims=spec["dims"], RB=spec["RB"], perm=perm,
    )
    md2 = float(np.float32(max_dist_match2))
    guard = torch.zeros((), dtype=torch.int32, device=dev)
    npairs = torch.zeros((), dtype=torch.float32, device=dev)
    big = torch.full((), float("inf"), dtype=torch.float64, device=dev)
    conv = (
        big, big, big,
        torch.zeros((), dtype=torch.bool, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
    )
    eps = float(epsilon)
    for it in range(max_iterations):
        tgt_g = _chain_transform(T, target_local)
        # RB=None: this card's K2 walks ranges of any length, so the table
        # is not clamped and no overflow lane runs
        idx, _d2, found, overflow, oob_q = ncl.nn_cell_list_chained(
            tgt_g, tmask, clm, md2, dims=spec["dims"], RB=None,
            chunk=spec.get("chunk", 256), perm=perm,
        )
        metrics.count(CHAINED_TRIPS)
        T, conv, npairs = _chain_update_conv(
            model, idx, found, tgt_g, T, conv, eps, align_fn
        )
        guard = torch.maximum(guard, overflow.to(torch.int32) + oob_q + oob_m)
        if (it + 1) % check_every == 0 or it == max_iterations - 1:
            # the one device->host read of these check_every iterations
            done, guard_v = torch.stack([conv[3].to(torch.int32), guard]).tolist()
            if guard_v > 0:
                break  # exactness guard fired: caller redoes with brute
            if done:
                break
    err, n_it, n, guard_v = torch.stack([
        conv[0], conv[4].double(), npairs.double(), guard.double(),
    ]).tolist()
    return IcpResult(
        T=T, error=err, iterations=int(n_it), n_pairs=n, maxocc=int(guard_v)
    )


def _orthonormalize_rot(T):
    """Two Newton steps R <- R(3I - RᵀR)/2: re-orthonormalizes a
    near-rotation (accumulated f32 drift per match is ~1e-6)."""
    R = T[:3, :3]
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    for _ in range(2):
        R = R @ (1.5 * eye - 0.5 * (R.T @ R))
    T = T.clone()
    T[:3, :3] = R
    return T


def _rigid_inv_f32(T):
    """Inverse of a rigid 4x4 (Rᵀ, -Rᵀt)."""
    Rt = T[:3, :3].T
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = Rt
    out[:3, 3] = -(Rt @ T[:3, 3])
    return out


def register_sequence_device(
    locals_all,    # [S, N, 3] f32 reduced points, local frames
    masks_all,     # [S, N] bool
    mats_org,      # [S, 4, 4] f32 odometry poses (transMatOrg)
    mats0,         # [S, 4, 4] f32 current poses (== mats_org for fresh scans)
    max_dist_match2,
    epsilon,
    *,
    metascan: bool = False,
    extrapolate: bool = True,
    window_cap: int = 1,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    pairing: str = "closest_point",
):
    """The whole sequential registration, scan after scan on the device
    (the reference's ``icp6D::doICP``, icp6D.cc:374-437): odometry
    extrapolation, a full ICP match against the resident model window,
    pose update.  The poses stay on the device between matches.

    Returns (mats [S,4,4] f32 device tensor, errs [S] f32, iters [S]
    int32, npairs [S] f32 numpy); entry 0 keeps its pose.
    """
    S = masks_all.shape[0]
    mats = mats0.to(torch.float32).clone()
    errs = np.zeros(S, np.float32)
    iters = np.zeros(S, np.int32)
    npairs = np.zeros(S, np.float32)
    for i in range(1, S):
        if extrapolate:
            # deltaMat = prev.transMat @ inv(prev.transMatOrg), applied
            # to the target's current pose (scan.cc:826-833)
            delta = mats[i - 1] @ _rigid_inv_f32(mats_org[i - 1])
            T0 = delta @ mats[i]
        else:
            T0 = mats[i]
        lo = 0 if metascan else i - 1
        res = icp_pair_seq(
            locals_all, masks_all, mats, lo, i, i, T0,
            max_dist_match2, epsilon, i,
            max_iterations=max_iterations, minimizer=minimizer,
            subsample=subsample, pairing=pairing, window_cap=window_cap,
        )
        mats[i] = _orthonormalize_rot(res.T)
        errs[i] = res.error
        iters[i] = res.iterations
        npairs[i] = res.n_pairs
    return mats, errs, iters, npairs
