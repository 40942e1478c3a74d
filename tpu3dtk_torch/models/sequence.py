"""Sequential registration driver — the port of
``tpu3dtk.models.sequence`` (the reference's ``icp6D::doICP``,
src/slam6d/icp6D.cc:374-437) over a scan sequence, with odometry
extrapolation (``Scan::mergeCoordinatesWithRoboterPosition``,
scan.cc:826-833) and metascan mode (include/slam6d/metaScan.h:41-71).

The sequence is uploaded once as resident [S, N, 3] tensors; every
match builds its model window from them on the device and runs an ICP
loop of ``models.icp``.  Two NN engines, as in the JAX package:

- the brute kernel (K1), exact at any window size, inside
  ``icp.register_sequence_device``;
- the chained cell-list engine (K2, ``icp.icp_pair_chained``) for model
  windows of ``chained_min`` points or more, when a cell-list spec fits
  and its candidate volume beats brute (9·RB < window points; RB is the
  JAX package's TPU sizing, which the port keeps as this gate only).  A
  match whose grid-box guard fired is redone with the brute engine.

The JAX package gates the chained engine on a TPU backend; the port
gates on the sizes alone, so the CPU tests run it through the plain
version of K2.  Normals-based pairing, subsampling and the minimizers
that need normals or the pose (napx, lumeuler, lumquat) stay on brute.
The JAX package's mesh is not a field here: its drivers run the sequence
unsplit under ``--distributed``, and a process drives one card, so
"auto" is always a world of one; ``parallel.icp_shard`` splits one match
over a process group.  The hashed grid is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import math3d
from ..core.scan import Scan
from ..io.frames import AlgoType
from ..utils.metrics import MATCHING, metrics
from . import icp as icp_mod

__all__ = ["SequenceRegistration"]

# metrics counters: matches sent to the chained engine, and those among
# them redone by the brute engine because an exactness guard fired
CHAINED_MATCHES = "chained_icp_matches"
CHAINED_REDONE = "chained_icp_matches_redone_brute"
# metrics timer: _prepare's upload of a sequence it has not cached
# (padding, upload, normals, the chained engine's cell-list spec)
SEQUENCE_PREPARE = "sequence_prepare_time"

_PAD = 512  # every scan's reduced points are padded to a multiple of this


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _orthonormal(T) -> np.ndarray:
    """f64 copy of T with its rotation projected onto SO(3) by SVD."""
    T = np.asarray(T, dtype=np.float64).copy()
    u, _, vt = np.linalg.svd(T[:3, :3])
    T[:3, :3] = u @ vt
    return T


def _record_match(scans: list[Scan], i: int, T_new: np.ndarray) -> None:
    """Frames bookkeeping of one match event (ref transform(islum=0)):
    ICP for the current scan, ICPINACTIVE for the registered ones,
    INVALID for the future ones."""
    cur = scans[i]
    cur.set_pose(T_new, AlgoType.ICP)
    for j, other in enumerate(scans):
        if other is not cur:
            other.add_frame(AlgoType.ICPINACTIVE if j < i else AlgoType.INVALID)


@dataclasses.dataclass
class SequenceRegistration:
    """Registration run over an ordered scan list."""

    params: icp_mod.IcpParams = dataclasses.field(default_factory=icp_mod.IcpParams)
    metascan: bool = False  # ref --metascan
    # keep only the last n scans in the metascan model (0: all of them);
    # the window of match i is scans [max(0, i - n), i)
    max_num_metascans: int = 0
    extrapolate_odometry: bool = True  # ref -e / eP flag (default on)
    device: torch.device | str | None = None  # None: the package default
    # chained cell-list ICP (K2): used when the model window reaches this
    # many points AND the cell-list candidate volume beats brute
    # (9*RB < window points) — the O(Q*occupancy) engine for city-scale
    # models (see models.icp.icp_pair_chained)
    chained_min: int = 98304

    def _device(self) -> torch.device:
        if self.device is None:
            from .. import default_device

            return default_device()
        return torch.device(self.device)

    def run(self, scans: list[Scan]) -> list[dict]:
        """Register scans sequentially.  Mutates scan poses and frames.
        Returns per-match info dicts.  The whole loop runs with the poses
        resident on the device (``icp.register_sequence_device``)."""
        if not scans:
            return []
        prep = self._prepare(scans)
        win_max = self._win_max(len(scans))
        if prep["chain_spec"] is None:
            return self._run_device(scans, prep, win_max)
        return [self.run_single(scans, i) for i in range(1, len(scans))]

    def _run_device(self, scans: list[Scan], prep: dict, win_max: int):
        dev = prep["device"]
        mats_org = torch.as_tensor(
            np.stack([s.transMatOrg for s in scans]), dtype=torch.float32,
            device=dev,
        )
        mats0 = torch.as_tensor(
            np.stack([s.transMat for s in scans]), dtype=torch.float32,
            device=dev,
        )
        with metrics.time(MATCHING):
            mats, errs, iters, npairs = icp_mod.register_sequence_device(
                prep["locals"], prep["masks"], mats_org, mats0,
                self.params.max_dist_match2, self.params.epsilon,
                extrapolate=self.extrapolate_odometry,
                window_cap=win_max,
                max_iterations=self.params.max_iterations,
                minimizer=self.params.minimizer,
                subsample=self.params.subsample,
                pairing=self.params.pairing,
                normals_all=prep["normals"],
            )
            mats = mats.cpu().numpy()
        infos = []
        for i in range(1, len(scans)):
            _record_match(scans, i, _orthonormal(mats[i]))
            infos.append({
                "identifier": scans[i].identifier,
                "iterations": int(iters[i]),
                "error": float(errs[i]),
                "pairs": int(npairs[i]),
            })
        return infos

    def _win_max(self, n_scans: int) -> int:
        """The largest model window (in scans) any match of the run sees."""
        if not self.metascan:
            return 1
        return self.max_num_metascans or n_scans

    def _window_of(self, i: int, n_scans: int) -> tuple[int, int]:
        """(lo, window_cap) of match i: the previous scan, or the
        metascan of scans [max(0, i - n), i) with n = max_num_metascans
        (all earlier scans when it is 0)."""
        if not self.metascan:
            return i - 1, 1
        if self.max_num_metascans > 0:
            return max(0, i - self.max_num_metascans), self.max_num_metascans
        return 0, n_scans

    def _need_normals(self) -> bool:
        return self.params.pairing != "closest_point" or self.params.minimizer == "napx"

    def _prepare(self, scans: list[Scan]) -> dict:
        """Upload the sequence once as resident [S, N, 3] / [S, N]
        tensors, every scan padded to one cap (cached per content); with
        normals-based pairing or the napx minimizer also the reduced
        points' local normals [S, N, 3] (``Scan.reduced_normals_local``,
        estimated on the scans' device)."""
        dev = self._device()
        key = (
            tuple(
                (s.identifier, s.generation, len(s.reduced_local()))
                for s in scans
            ),
            self.params,
            str(dev),
            self.metascan,
            self.max_num_metascans,
            self.chained_min,
        )
        prep = getattr(self, "_prep", None)
        if prep is not None and prep["key"] == key:
            return prep
        with metrics.time(SEQUENCE_PREPARE):
            cap = _round_up(max(len(s.reduced_local()) for s in scans), _PAD)
            S = len(scans)
            locals_pad = np.zeros((S, cap, 3), np.float32)
            masks = np.zeros((S, cap), bool)
            for si, s in enumerate(scans):
                r = s.reduced_local()
                locals_pad[si, : len(r)] = r
                masks[si, : len(r)] = True
            normals = None
            if self._need_normals():
                normals = torch.as_tensor(
                    np.stack([s.reduced_normals_padded(cap) for s in scans]), device=dev
                )
            prep = dict(
                key=key,
                device=dev,
                cap=cap,
                chain_spec=self._chain_spec(scans, cap),
                locals=torch.as_tensor(locals_pad, device=dev),
                masks=torch.as_tensor(masks, device=dev),
                normals=normals,
            )
        self._prep = prep
        return prep

    def _chain_spec(self, scans: list[Scan], cap: int):
        """Cell-list spec of the chained engine, or None when the run
        stays on the brute engine (small windows, subsampling, normals,
        a minimizer that takes the pose, or no spec that fits and beats
        brute).  The JAX package's gate lets napx through to an engine
        without normals, where it fails; here napx stays on brute."""
        win_max = self._win_max(len(scans))
        if not (
            self.params.pairing == "closest_point"
            and self.params.subsample == 1
            and self.params.minimizer not in ("lumeuler", "lumquat", "napx")
            and win_max * cap >= self.chained_min
        ):
            return None
        from ..ops import nn_cell_list as ncl

        clouds = [
            np.asarray(
                math3d.transform3(s.transMat, s.reduced_local())
            ).astype(np.float32)
            for s in scans
        ]
        max_dist = float(np.sqrt(self.params.max_dist_match2))
        dev = self._device()
        if win_max <= 1:
            # window-1 matching: the model is ONE scan per match — size
            # RB against per-scan models and the consecutive-pair query
            # pattern (the union overestimates by the overlap factor and
            # declines on dense city clouds)
            spec = ncl.cell_list_spec(
                clouds, max_dist, headroom=2.0,
                model_sets=clouds, queries=clouds,
                pairs=[(i - 1, i) for i in range(1, len(clouds))],
                device=dev,
            )
        else:
            spec = ncl.cell_list_spec(
                clouds, max_dist, headroom=2.0, queries=clouds,
                device=dev,
            )
        if spec is not None and 9 * spec["RB"] < win_max * cap:
            return spec
        return None

    def run_single(self, scans: list[Scan], i: int) -> dict:
        """Register scan i against the previous scan (or the metascan of
        the earlier scans): odometry extrapolation, one ICP match, frames
        bookkeeping (the loop body of doICP, icp6D.cc:383-437)."""
        prep = self._prepare(scans)
        cur = scans[i]
        prev = scans[i - 1]
        if self.extrapolate_odometry:
            # deltaMat = prev.transMat @ inv(prev.transMatOrg)
            delta = prev.transMat @ np.asarray(math3d.m4inv(prev.transMatOrg))
            cur.transform(delta, AlgoType.INVALID, record=False)
        lo, window_cap = self._window_of(i, len(scans))
        dev = prep["device"]
        mats = torch.as_tensor(
            np.stack([s.transMat for s in scans]), dtype=torch.float32,
            device=dev,
        )
        T0 = torch.as_tensor(cur.transMat, dtype=torch.float32, device=dev)

        def match_brute():
            return icp_mod.icp_pair_seq(
                prep["locals"], prep["masks"], mats, lo, i, i, T0,
                self.params.max_dist_match2, self.params.epsilon, i,
                max_iterations=self.params.max_iterations,
                minimizer=self.params.minimizer,
                subsample=self.params.subsample,
                pairing=self.params.pairing,
                window_cap=window_cap,
                normals_all=prep["normals"],
            )

        # per-match engine choice from the ACTUAL model-window size
        use_chain = (
            prep["chain_spec"] is not None
            and window_cap * prep["cap"] >= self.chained_min
        )
        with metrics.time(MATCHING):
            if use_chain:
                model, mmask = icp_mod._window(
                    prep["locals"], prep["masks"], mats, lo, i, window_cap
                )
                res = icp_mod.icp_pair_chained(
                    model, mmask, prep["locals"][i], prep["masks"][i], T0,
                    max_dist_match2=self.params.max_dist_match2,
                    epsilon=self.params.epsilon,
                    max_iterations=self.params.max_iterations,
                    minimizer=self.params.minimizer,
                    spec=prep["chain_spec"],
                )
                metrics.count(CHAINED_MATCHES)
                if res.maxocc > 0:
                    # cell-list guard fired: redo exactly with brute
                    metrics.count(CHAINED_REDONE)
                    res = match_brute()
            else:
                res = match_brute()
            T_res = res.T.cpu().numpy()
        _record_match(scans, i, _orthonormal(T_res))
        return {
            "identifier": cur.identifier,
            "iterations": res.iterations,
            "error": float(np.float32(res.error)),
            "pairs": int(res.n_pairs),
        }

