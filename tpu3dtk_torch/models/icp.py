"""ICP matching engine — the port of ``tpu3dtk.models.icp`` (the
reference's ``icp6D``, src/slam6d/icp6D.cc:104-285).

Each iteration, on the device of the clouds:

  1. transform the target points by the current pose (local points stay
     immutable; the pose is composed instead),
  2. correspondences against the model, prepared once per match
     (``ops.nn.prepare_brute_model``, ``ops.nn.nn_brute_auto``: the CUDA
     kernel on a card, the plain version on the CPU), projected onto the
     target's tangent plane for point-to-plane pairing; normal shooting
     ranks along the target's normal rays (plain torch),
  3. masked centred pair statistics (ref icp6D.cc:144-191),
  4. a closed-form minimizer (``models.minimizers``; point-to-plane
     statistics for napx, the current pose for lumeuler / lumquat),
  5. pose update T <- align @ T (ref transformMatrix, scan.cc:878-898),
  6. the stop tests of the JAX package: the two-delta test
     |err - prev| < eps and |err - prevprev| < eps (ref
     icp6D.cc:266-279) on an f64 error, the pose-fixpoint test and
     n ≤ 3 pairs.

The JAX package runs this as one ``lax.while_loop``; here it is a Python
loop that reads four scalars back from the device once per iteration
for the stop tests.  Steps 1-5 are one function, :func:`_icp_step`.  On
a card, where nothing in it reads the host (no ``group``, no ``-R``
draw, a minimizer and pairing of ``GRAPH_SAFE``), a match shape met a
second time has its first iteration run once and captured as a CUDA
graph; every later iteration of that shape is one replay of the graph
and one read (:class:`GraphCache`).  Everywhere else, and in a shape's
first match, each iteration runs it eagerly.  Both give the same poses
bit for bit.

:func:`icp_pair_chained` is the second engine, for large models:
nearest neighbours through the cell-list chain (kernel K2,
``ops.nn_cell_list``), the stop tests evaluated on the device and read
back every fourth loop trip.  A trip is one function,
:func:`_chained_trip`, with no host read inside.  On a card, for a
minimizer of ``CHAINED_GRAPH_SAFE``, a match key (shapes, grid, cell
edge, radius, epsilon) met a second time has its first trip run once and
captured as a CUDA graph; every later trip of that key is one replay
(a cache of its own, apart from the brute engine's).  Everywhere else,
and in a key's first match, each trip runs eagerly.  Both give the same
poses bit for bit.  Pairing semantics match
``SearchTree::getPtPairs`` (src/slam6d/searchTree.cc:91-188): model
points in the model's current global frame, target points in the
target's current estimate, matches at or beyond max_dist_match2
rejected.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..core import math3d
from ..ops import nn as nn_ops
from ..utils.metrics import (
    BRUTE_ICP_ITERATIONS, CHAINED_GRAPH_REPLAYS, ICP_GRAPH_REPLAYS, metrics,
)
from . import minimizers as mz

__all__ = [
    "CHAINED_GRAPH_SAFE", "GRAPH_SAFE", "GraphCache", "IcpParams", "IcpResult", "icp_pair",
    "icp_pair_chained", "icp_pair_seq", "icp_window_align",
    "register_sequence_device",
]

# metrics counter: loop trips of the chained engine (one cell-list NN
# call each; the reported iterations stop counting once a match is done)
CHAINED_TRIPS = "chained_icp_loop_trips"

# (minimizer, pairing) pairs whose iteration a CUDA graph can hold: no
# host read and no tensor built from host data inside.  svd and ortho
# call eigh, apx, helix, the lum forms and napx solve: each checks its
# result on the host.  normal shooting ranks in plain torch tiles.
GRAPH_SAFE = frozenset(
    (m, p) for m in ("quat", "quatscale", "dual") for p in ("closest_point", "closest_plane")
)
# minimizers whose chained loop trip a CUDA graph can hold: those of
# GRAPH_SAFE (the chained engine pairs closest points)
CHAINED_GRAPH_SAFE = frozenset(m for m, p in GRAPH_SAFE if p == "closest_point")

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
    pairing: str = "closest_point"  # ref PairingMode (pairingMode.h):
    # "closest_point" | "closest_plane" (point-to-plane projection) |
    # "along_normal" (normal shooting)


class IcpResult(NamedTuple):
    T: torch.Tensor  # [4,4] f32 final pose of the target scan (global)
    error: float  # final RMS point-to-point error (f64)
    iterations: int  # iterations executed
    n_pairs: float  # pairs in the last iteration
    # chained engine only: > 0 when the cell-list exactness guard fired
    # (a point outside the grid box) and the caller must redo the match
    # with the brute engine
    maxocc: int = 0


def _find_pairs(bm: nn_ops.BruteModel, tgt_global, tmask, max_dist2,
                pairing="closest_point", tgt_normals=None):
    """Correspondences for one iteration against the prepared model:
    matched model points [N,3] and the accept mask [N]
    (SearchTree::getPtPairs, searchTree.cc:126-163).  ``closest_point``
    and ``closest_plane`` take the nearest model point (kernel K1 on the
    card); ``closest_plane`` then projects it onto the plane through the
    target point with the target's normal, s' = (n·(s−t))n + t;
    ``along_normal`` (normal shooting) ranks by the distance to the
    target's normal ray, plain torch as the JAX package leaves it to
    XLA."""
    if pairing == "along_normal":
        idx, _d2, found = nn_ops.nn_brute_line(
            tgt_global, tgt_normals, tmask, bm.model, bm.mmask, max_dist2
        )
    else:
        idx, _d2, found = nn_ops.nn_brute_auto(
            tgt_global, tmask, bm, None, max_dist2
        )
    m_pts = bm.model[idx]
    if pairing == "closest_plane":
        dot = (tgt_normals * (m_pts - tgt_global)).sum(1, keepdim=True)
        m_pts = tgt_global + dot * tgt_normals
    return m_pts, found


def icp_pair(
    model, mmask, target_local, tmask, T0, *,
    max_dist_match2, epsilon,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    seed: int = 0,
    pairing: str = "closest_point",
    target_normals_local=None,
    group=None,
) -> IcpResult:
    """Match one target scan against fixed model points.

    model: [M,3] f32 model points in the global frame; target_local:
    [N,3] f32 target points in the target's **local** frame; masks bool;
    T0: [4,4] initial global pose of the target.  All on one device.

    ``subsample`` = the reference's ``rnd`` (-R): each iteration keeps a
    fresh ~1/subsample random subset of the target points
    (searchTree.cc:54-55), drawn from a CPU ``torch.Generator`` seeded
    with ``seed`` (the JAX package draws from ``jax.random``).

    ``pairing`` (the reference's PairingMode): ``closest_point``,
    ``closest_plane`` (point-to-plane projection) or ``along_normal``
    (normal shooting); the last two, and the ``napx`` minimizer, need
    ``target_normals_local`` [N,3], the target's unit normals in its
    local frame, carried to the global frame by the current pose each
    iteration.  ``lumeuler`` / ``lumquat`` are given the current pose
    (ref icp6D.cc:242-245).

    ``group``: a ``torch.distributed`` process group whose ranks each
    hold an equal contiguous slice of one target (in rank order, with
    its mask and normals; ``parallel.icp_shard``): the pair statistics
    are summed over the ranks (``minimizers.pair_stats``), so every rank
    takes the same steps and ends with the same pose.  A subsampling
    draw covers the whole target and each rank keeps its slice.

    Each iteration is :func:`_icp_step`, eagerly or as a replay of its
    CUDA graph (see the module docstring); the host reads its four stop
    scalars once per iteration either way.
    """
    if pairing not in ("closest_point", "closest_plane", "along_normal"):
        raise ValueError(f"unknown pairing {pairing!r}")
    need_normals = pairing != "closest_point" or minimizer == "napx"
    if need_normals and target_normals_local is None:
        raise ValueError(f"pairing {pairing!r} with minimizer {minimizer!r} needs target normals")
    mz.get_minimizer(minimizer)  # an unknown name raises before any work
    dev = model.device
    # the model is fixed for the whole match: centred and packed once
    bm = nn_ops.prepare_brute_model(model.to(torch.float32).contiguous(), mmask)
    target_local = target_local.to(torch.float32)
    normals = target_normals_local if need_normals else None
    T = torch.as_tensor(T0, dtype=torch.float32, device=dev)
    eps = float(np.float32(epsilon))
    md2 = float(np.float32(max_dist_match2))
    gen = torch.Generator().manual_seed(int(seed)) if subsample > 1 else None
    rows = tmask.shape[0]
    draw_lo, draw_n = 0, rows
    if group is not None:
        import torch.distributed as dist

        draw_lo, draw_n = dist.get_rank(group) * rows, dist.get_world_size(group) * rows

    def step(bm, target_local, tmask, T, normals):
        return _icp_step(bm, target_local, tmask, T, normals, md2, minimizer, pairing, group)

    graph_key = None
    captured = None
    if _graph_path(dev, subsample, group, minimizer, pairing):
        graph_key = (dev, rows, bm.model.shape[0], md2, minimizer, pairing)
        captured = _GRAPHS.get(graph_key)
        if captured is not None:
            captured.load(bm, target_local, tmask, T, normals)
        elif not _GRAPHS.recurs(graph_key):
            graph_key = None  # a shape's first match runs eagerly

    ret = prev = prev2 = 0.0
    npairs = 0.0
    it = replays = 0
    done = False
    while not done and it < max_iterations:
        if captured is not None:
            stop = captured.replay()
            replays += 1
        elif graph_key is not None:
            T, stop, captured = _CapturedIteration.first(step, bm, target_local, tmask, T, normals)
            _GRAPHS.put(graph_key, captured)
        else:
            it_mask = tmask
            if gen is not None:
                keep = torch.randint(0, subsample, (draw_n,), generator=gen)[draw_lo : draw_lo + rows] == 0
                it_mask = tmask & keep.to(dev)
            T, stop = step(bm, target_local, it_mask, T, normals)
        # the one device->host read of the iteration
        n, err_v, tnorm, rnorm = stop.tolist()
        enough = n > 3
        prev2, prev = prev, ret
        if enough:
            ret = err_v
        conv = abs(ret - prev) < eps and abs(ret - prev2) < eps
        pose_conv = tnorm < _POSE_T and rnorm < _POSE_R
        done = conv or (pose_conv and enough) or not enough
        npairs = n
        it += 1
    if replays:
        T = captured.T.clone()  # the static pose is the next match's input
    metrics.count(BRUTE_ICP_ITERATIONS, it)
    metrics.count(ICP_GRAPH_REPLAYS, replays)
    return IcpResult(T=T, error=ret, iterations=it, n_pairs=npairs)


def _icp_step(bm: nn_ops.BruteModel, target_local, tmask, T, normals_local,
              md2: float, minimizer: str, pairing: str, group=None):
    """One ICP iteration on the device, steps 1-5 of the module
    docstring: the pose after it (``T`` where there are not more than 3
    pairs) and the f64 [4] stop scalars (pairs, RMS error, |t| and
    ||R - I|| of the alignment).  No host read and no host-built tensor:
    on a card a CUDA graph can hold it for the pairs of ``GRAPH_SAFE``."""
    align_fn = mz.get_minimizer(minimizer)
    tgt_global = math3d.transform3(T, target_local)
    normals_g = None
    if normals_local is not None:
        normals_g = math3d.transform3normal(T, normals_local).to(torch.float32)
    m_pts, found = _find_pairs(bm, tgt_global, tmask, md2, pairing, normals_g)
    if minimizer == "napx":
        stats = mz.napx_stats(m_pts, tgt_global, normals_g, found, group)
        align, err = align_fn(stats)
    elif minimizer in mz.POSE_MINIMIZERS:
        stats = mz.pair_stats(m_pts, tgt_global, found, group)
        align, err = align_fn(stats, T)
    else:
        stats = mz.pair_stats(m_pts, tgt_global, found, group)
        align, err = align_fn(stats)
    eye3 = torch.eye(3, dtype=torch.float32, device=T.device)
    stop = torch.stack([
        stats.n.double(),
        err.double(),
        torch.linalg.norm(align[:3, 3]).double(),
        torch.linalg.norm(align[:3, :3] - eye3).double(),
    ])
    return torch.where(stats.n > 3, align @ T, T), stop


def _graph_path(device, subsample: int, group, minimizer: str, pairing: str) -> bool:
    """Whether a match's iterations run as CUDA graph replays: on a card,
    with no collective (``group``), no per-iteration CPU draw (``-R``)
    and a minimizer and pairing of ``GRAPH_SAFE``."""
    return (
        torch.device(device).type == "cuda" and group is None and subsample == 1
        and (minimizer, pairing) in GRAPH_SAFE
    )


class _Captured:
    """A loop step captured as a CUDA graph, and the calls of a kernel
    wrapper in it (``ops.nn_cuda.CapturedCalls``)."""

    def _capture(self, kernel, record) -> None:
        """Record ``record()`` into a new graph; ``kernel``'s calls in it
        count once for each replay."""
        from ..ops import nn_cuda

        self.graph = torch.cuda.CUDAGraph()
        # capture_begin directly: torch.cuda.graph would also synchronize,
        # collect garbage and empty the allocator's cache at every capture.
        # Thread-local: other threads keep the card meanwhile (streaming's
        # prefetch workers reduce scans there, with syncs and allocations)
        with nn_cuda.CapturedCalls(kernel) as self.calls:
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                record()
            finally:
                self.graph.capture_end()

    def _replay(self, device) -> None:
        with torch.cuda.device(device):  # the current stream of the graph's card
            self.graph.replay()
        self.calls.replayed()


def _on_side_stream(device, fn):
    """``fn()`` on a new stream ordered after the current one, which then
    waits for it: a capture's warm-up run and the capture itself."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


class _CapturedIteration(_Captured):
    """One ICP iteration of one match shape as a CUDA graph: static copies
    of the match's inputs, the pose ``T`` that each replay advances, and
    the stop scalars each replay writes.  Built on a side stream, after
    the iteration ran there once (K1's library is loaded, cuBLAS set up)."""

    def __init__(self, step, bm, target_local, tmask, T, normals):
        from ..ops import nn_cuda

        self.bm = nn_ops.BruteModel(*(x.clone() for x in bm))
        self.target = target_local.clone()
        self.tmask = tmask.clone()
        self.T = T.clone()
        self.normals = None if normals is None else normals.clone()

        def record():
            T_next, self.stop = step(self.bm, self.target, self.tmask, self.T, self.normals)
            self.T.copy_(T_next)

        self._capture(nn_cuda.nn_brute_kernel, record)

    @classmethod
    def first(cls, step, bm, target_local, tmask, T, normals):
        """The first iteration of a shape's second match: run once on a
        side stream (the warm-up a capture needs), then captured there.  Returns the
        pose after it, its stop scalars and the captured iteration, whose
        static pose holds that pose."""

        def run():
            T1, stop = step(bm, target_local, tmask, T, normals)
            return T1, stop, cls(step, bm, target_local, tmask, T1, normals)

        return _on_side_stream(T.device, run)

    def load(self, bm, target_local, tmask, T, normals):
        """Copy a new match's inputs into the static tensors."""
        for dst, src in zip(self.bm, bm):
            dst.copy_(src)
        self.target.copy_(target_local)
        self.tmask.copy_(tmask)
        self.T.copy_(T)
        if normals is not None:
            self.normals.copy_(normals)

    def replay(self):
        """Run the iteration once; returns its stop scalars (static)."""
        self._replay(self.T.device)
        return self.stop


class GraphCache:
    """Captured iterations by match shape, at most ``cap`` of them: the
    least recently used goes first, and with it its graph and the
    graph's memory pool.  A shape is captured in its second match
    (:meth:`recurs`), so a caller whose every match has a new shape
    (unpadded streamed scans, veloslam's windows) pays no capture; the
    last ``seen_cap`` shapes are remembered."""

    def __init__(self, cap: int, seen_cap: int = 64):
        self.cap = cap
        self.entries: OrderedDict = OrderedDict()
        self.seen_cap = seen_cap
        self.seen: OrderedDict = OrderedDict()

    def recurs(self, key) -> bool:
        """Whether a match of this shape came before; remembers this one."""
        known = key in self.seen
        self.seen[key] = None
        self.seen.move_to_end(key)
        while len(self.seen) > self.seen_cap:
            self.seen.popitem(last=False)
        return known

    def get(self, key):
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > self.cap:
            self.entries.popitem(last=False)


# a GraphPipeline run matches two shapes a scan cap (the sequential match
# and the loop-closure window): 8 hold those of a few caps
_GRAPHS = GraphCache(8)


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
    normals_all=None,
) -> IcpResult:
    """Sequence-resident match: the model is built on the device from the
    resident [S, N, 3] local points and the current poses ``mats``
    [S, 4, 4] (scans [lo, hi) of a ``window_cap``-scan window, 0 = all),
    and scan ``tgt_idx`` is matched against it from pose ``T0``.
    ``normals_all``: the resident [S, N, 3] local-frame normals, for the
    pairings and the minimizer that need them."""
    model, mmask = _window(locals_all, masks_all, mats, lo, hi, window_cap)
    return icp_pair(
        model, mmask, locals_all[tgt_idx], masks_all[tgt_idx], T0,
        max_dist_match2=max_dist_match2, epsilon=epsilon,
        max_iterations=max_iterations, minimizer=minimizer,
        subsample=subsample, seed=seed, pairing=pairing,
        target_normals_local=None if normals_all is None else normals_all[tgt_idx],
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


class _ChainState(NamedTuple):
    """The chained loop's state, on the device: what one trip reads and
    writes."""

    T: torch.Tensor       # [4, 4] f32 pose of the target
    err: torch.Tensor     # f64 RMS error of the last trip (inf before the first)
    prev: torch.Tensor    # f64 the error of the trip before
    prev2: torch.Tensor   # f64 the error two trips before
    done: torch.Tensor    # bool: converged, or too few pairs; the pose is frozen
    n_it: torch.Tensor    # int32 iterations counted (trips before done)
    guard: torch.Tensor   # int32 largest box-exit count of model + query so far
    npairs: torch.Tensor  # f32 pairs of the last trip

    @classmethod
    def start(cls, T):
        dev = T.device
        big = torch.full((), float("inf"), dtype=torch.float64, device=dev)
        return cls(
            T, big, big, big,
            torch.zeros((), dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.float32, device=dev),
        )


def _chained_trip(clm, oob_m, target_local, tmask, s: _ChainState, *,
                  md2: float, eps: float, align_fn, dims, chunk: int, perm) -> _ChainState:
    """One trip of the chained loop on the device: the transform, the
    cell-list chain (query plan, K2, post), the update with its on-device
    stop state and the exactness guard.  ``clm``, ``oob_m``: the match's
    cell-list model and its box-exit count.  No host read and no
    host-built tensor: on a card a CUDA graph can hold it for the
    minimizers of ``CHAINED_GRAPH_SAFE``."""
    from ..ops import nn_cell_list as ncl

    tgt_g = _chain_transform(s.T, target_local)
    idx, _d2, found, oob_q = ncl.nn_cell_list_chained(
        tgt_g, tmask, clm, md2, dims=dims, chunk=chunk, perm=perm,
    )
    T, conv, npairs = _chain_update_conv(
        clm.points, idx, found, tgt_g, s.T, s[1:6], eps, align_fn
    )
    return _ChainState(T, *conv, torch.maximum(s.guard, oob_q + oob_m), npairs)


def _chained_graph_path(device, minimizer: str) -> bool:
    """Whether a chained match's trips run as CUDA graph replays: on a
    card, with a minimizer of ``CHAINED_GRAPH_SAFE``."""
    return torch.device(device).type == "cuda" and minimizer in CHAINED_GRAPH_SAFE


def _chained_key(clm, target_local, md2: float, eps: float, minimizer: str,
                 dims, chunk: int, perm) -> tuple:
    """What a captured trip bakes in: the card, the target's and the
    model's rows, the grid (``dims``, and with it the size of
    ``cell_start``), the query chunk, the axis order, the cell edge, the
    match radius, epsilon and the minimizer."""
    return (
        clm.points.device, target_local.shape[0], clm.points.shape[0], tuple(dims),
        int(chunk), tuple(perm), clm.cell, md2, eps, minimizer,
    )


class _CapturedTrip(_Captured):
    """One chained loop trip of one match key as a CUDA graph: static
    copies of the match's inputs (the cell-list model, its box-exit
    count, the target and its mask) and the loop state that each replay
    advances in place.  Built on a side stream, after the trip ran there
    once (K2's library is loaded, cuBLAS set up)."""

    def __init__(self, trip, clm, oob_m, target_local, tmask, state: _ChainState):
        from ..ops import nn_cell_list_cuda

        self.clm = type(clm)(*(x.clone() if isinstance(x, torch.Tensor) else x for x in clm))
        self.oob_m = oob_m.clone()
        self.target = target_local.clone()
        self.tmask = tmask.clone()
        self.state = _ChainState(*(x.clone() for x in state))

        def record():
            new = trip(self.clm, self.oob_m, self.target, self.tmask, self.state)
            # the convergence state shifts err -> prev -> prev2: an output
            # that is a state tensor itself is read before it is written
            new = [x.clone() if any(x is y for y in self.state) else x for x in new]
            for dst, src in zip(self.state, new):
                dst.copy_(src)

        self._capture(nn_cell_list_cuda.cell_list_rows_kernel, record)

    @classmethod
    def first(cls, trip, clm, oob_m, target_local, tmask, state: _ChainState):
        """The first trip of a key's second match: run once on a side
        stream, then captured there.  The captured trip's static state
        holds the state after that first trip."""
        return _on_side_stream(state.T.device, lambda: cls(
            trip, clm, oob_m, target_local, tmask,
            trip(clm, oob_m, target_local, tmask, state),
        ))

    def load(self, clm, oob_m, target_local, tmask, state: _ChainState) -> None:
        """Copy a new match's inputs and starting state into the static
        tensors."""
        for dst, src in zip(self.clm, clm):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        self.oob_m.copy_(oob_m)
        self.target.copy_(target_local)
        self.tmask.copy_(tmask)
        for dst, src in zip(self.state, state):
            dst.copy_(src)

    def replay(self) -> None:
        """Run the trip once: the static state advances."""
        self._replay(self.state.T.device)


# a city run matches one key a spec (window 1, every scan padded to one
# cap); metascan runs one a window size: 4 hold those of a few runs
_CHAINED_GRAPHS = GraphCache(4)


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

    Each loop trip is :func:`_chained_trip`, a chain of device ops
    (transform, device query plan, cell-list kernel, pair statistics and
    update) with no host read inside: the two-delta convergence test
    runs ON DEVICE every trip (the pose freezes once converged) and the
    host polls the done flag and the guard only every ``check_every``
    trips and after the last, so the per-iteration NN cost is
    O(Q · occupancy) instead of O(Q · M).  On a card a trip runs eagerly
    or as a replay of its CUDA graph (see the module docstring); the
    host's reads, and so the trips, iterations and pose, are the same
    either way.  The cell-list model is built once a match, eagerly.

    Exactness guard: the model's and each iteration's out-of-grid-box
    counts accumulate on the device; if a point left the box, the caller
    must redo the match with the brute engine (returned via ``maxocc`` >
    0).
    ``spec`` comes from ``ops.nn_cell_list.cell_list_spec``; without one
    it is sized over the model, and the brute engine runs when no spec
    fits.  The ``napx`` minimizer needs normals, which this engine does
    not carry: it raises (SequenceRegistration keeps napx on the brute
    engine).
    """
    from ..ops import nn_cell_list as ncl

    if minimizer == "napx":
        raise ValueError("the chained engine carries no normals: napx runs on the brute engine")
    align_fn = mz.get_minimizer(minimizer)
    dev = model.device
    model = model.to(torch.float32).contiguous()
    target_local = target_local.to(torch.float32)
    T = torch.as_tensor(T0, dtype=torch.float32, device=dev)
    max_dist = float(np.sqrt(max_dist_match2))
    if spec is None:
        spec = ncl.cell_list_spec(model[mmask], max_dist)
    if spec is None:
        return icp_pair(
            model, mmask, target_local, tmask, T,
            max_dist_match2=max_dist_match2, epsilon=epsilon,
            max_iterations=max_iterations, minimizer=minimizer,
        )
    perm = tuple(spec.get("perm", (0, 1, 2)))
    dims, chunk = tuple(spec["dims"]), spec.get("chunk", 256)
    clm, oob_m = ncl.build_cell_list_model(
        model, mmask, spec["origin"], max_dist, dims=dims, perm=perm,
    )
    md2 = float(np.float32(max_dist_match2))
    eps = float(epsilon)

    def trip(clm, oob_m, target_local, tmask, s):
        return _chained_trip(clm, oob_m, target_local, tmask, s, md2=md2, eps=eps,
                             align_fn=align_fn, dims=dims, chunk=chunk, perm=perm)

    s = _ChainState.start(T)
    key = captured = None
    if _chained_graph_path(dev, minimizer):
        key = _chained_key(clm, target_local, md2, eps, minimizer, dims, chunk, perm)
        captured = _CHAINED_GRAPHS.get(key)
        if captured is not None:
            captured.load(clm, oob_m, target_local, tmask, s)
            s = captured.state
        elif not _CHAINED_GRAPHS.recurs(key):
            key = None  # a key's first match runs eagerly
    replays = 0
    for it in range(max_iterations):
        if captured is not None:
            captured.replay()
            replays += 1
        elif key is not None:
            captured = _CapturedTrip.first(trip, clm, oob_m, target_local, tmask, s)
            _CHAINED_GRAPHS.put(key, captured)
            s = captured.state
        else:
            s = trip(clm, oob_m, target_local, tmask, s)
        metrics.count(CHAINED_TRIPS)
        if (it + 1) % check_every == 0 or it == max_iterations - 1:
            # the one device->host read of these check_every trips
            done, guard_v = torch.stack([s.done.to(torch.int32), s.guard]).tolist()
            if guard_v > 0:
                break  # exactness guard fired: caller redoes with brute
            if done:
                break
    err, n_it, n, guard_v = torch.stack([
        s.err, s.n_it.double(), s.npairs.double(), s.guard.double(),
    ]).tolist()
    metrics.count(CHAINED_GRAPH_REPLAYS, replays)
    # the static pose is the next match's input
    T = s.T.clone() if captured is not None else s.T
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
    extrapolate: bool = True,
    window_cap: int = 1,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    pairing: str = "closest_point",
    normals_all=None,
):
    """The whole sequential registration, scan after scan on the device
    (the reference's ``icp6D::doICP``, icp6D.cc:374-437): odometry
    extrapolation, a full ICP match against the resident model window,
    pose update.  The poses stay on the device between matches.
    ``normals_all``: resident [S, N, 3] local normals (see icp_pair_seq).
    Match i's model is scans [max(0, i - window_cap), i): the previous
    scan for 1, the metascan of the last n scans for n, of all earlier
    scans for S (the JAX package's per-match windows; its device loop
    starts every metascan window at scan 0).

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
        res = icp_pair_seq(
            locals_all, masks_all, mats, max(0, i - window_cap), i, i, T0,
            max_dist_match2, epsilon, i,
            max_iterations=max_iterations, minimizer=minimizer,
            subsample=subsample, pairing=pairing, window_cap=window_cap,
            normals_all=normals_all,
        )
        mats[i] = _orthonormalize_rot(res.T)
        errs[i] = res.error
        iters[i] = res.iterations
        npairs[i] = res.n_pairs
    return mats, errs, iters, npairs
