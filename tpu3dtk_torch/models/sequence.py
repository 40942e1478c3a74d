"""Sequential registration driver — the port of
``tpu3dtk.models.sequence`` (the reference's ``icp6D::doICP``,
src/slam6d/icp6D.cc:374-437) over a scan sequence, with odometry
extrapolation (``Scan::mergeCoordinatesWithRoboterPosition``,
scan.cc:826-833) and metascan mode (include/slam6d/metaScan.h:41-71).

The sequence is uploaded once as resident [S, N, 3] tensors; every
match builds its model window from them on the device and runs the ICP
loop of ``models.icp``.  Every model window goes through the brute NN
kernel (K1), which is exact at any window size; the JAX package's
multi-device mesh, hashed grid and chained cell-list engines are not
ported (the cell-list kernel K2 is ROADMAP slice B).
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
    extrapolate_odometry: bool = True  # ref -e / eP flag (default on)
    device: torch.device | str | None = None  # None: the package default

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
        win_max = len(scans) if self.metascan else 1
        return self._run_device(scans, prep, win_max)

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
                metascan=self.metascan,
                extrapolate=self.extrapolate_odometry,
                window_cap=win_max,
                max_iterations=self.params.max_iterations,
                minimizer=self.params.minimizer,
                subsample=self.params.subsample,
                pairing=self.params.pairing,
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

    def _prepare(self, scans: list[Scan]) -> dict:
        """Upload the sequence once as resident [S, N, 3] / [S, N]
        tensors, every scan padded to one cap (cached per content)."""
        dev = self._device()
        key = (
            tuple(
                (s.identifier, s.generation, len(s.reduced_local()))
                for s in scans
            ),
            self.params,
            str(dev),
        )
        prep = getattr(self, "_prep", None)
        if prep is not None and prep["key"] == key:
            return prep
        cap = _round_up(max(len(s.reduced_local()) for s in scans), _PAD)
        S = len(scans)
        locals_pad = np.zeros((S, cap, 3), np.float32)
        masks = np.zeros((S, cap), bool)
        for si, s in enumerate(scans):
            r = s.reduced_local()
            locals_pad[si, : len(r)] = r
            masks[si, : len(r)] = True
        prep = dict(
            key=key,
            device=dev,
            locals=torch.as_tensor(locals_pad, device=dev),
            masks=torch.as_tensor(masks, device=dev),
        )
        self._prep = prep
        return prep

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
        lo, window_cap = (0, len(scans)) if self.metascan else (i - 1, 1)
        dev = prep["device"]
        mats = torch.as_tensor(
            np.stack([s.transMat for s in scans]), dtype=torch.float32,
            device=dev,
        )
        T0 = torch.as_tensor(cur.transMat, dtype=torch.float32, device=dev)
        with metrics.time(MATCHING):
            res = icp_mod.icp_pair_seq(
                prep["locals"], prep["masks"], mats, lo, i, i, T0,
                self.params.max_dist_match2, self.params.epsilon, i,
                max_iterations=self.params.max_iterations,
                minimizer=self.params.minimizer,
                subsample=self.params.subsample,
                pairing=self.params.pairing,
                window_cap=window_cap,
            )
            T_res = res.T.cpu().numpy()
        _record_match(scans, i, _orthonormal(T_res))
        return {
            "identifier": cur.identifier,
            "iterations": res.iterations,
            "error": float(np.float32(res.error)),
            "pairs": int(res.n_pairs),
        }

