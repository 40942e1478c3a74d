"""Full SLAM pipeline: sequential ICP + loop detection + ELCH loop
closure + LUM GraphSLAM relaxation — the port of
``tpu3dtk/models/graph_pipeline.py`` (the reference's
``matchGraph6Dautomatic``, src/slam6d/slam6D.cc:387-548).

Per scan i: odometry extrapolation, ICP against previous scan (or
metascan), loop detection by pose proximity (dist < cldist, j < i -
loopsize); one scan after a loop is detected, run ELCH on the closest
(first, last) pair and then LUM over the proximity graph.  Final passes
re-run LUM with -D (mdml) and optionally --DlastSLAM/--graphDist
(mdmll) distances.

The sequence is uploaded ONCE (``SequenceRegistration._prepare``) and
the same resident [S, cap, 3] / [S, cap] tensors serve the sequential
matches, the ELCH windows and edge covariances, and LUM.

The JAX package has a second, segmented loop that runs matching and
loop detection in on-device segments to pay one device fetch per closure
instead of one per match; an eager PyTorch ICP loop reads the host once
per iteration anyway, so the port has the per-match loop only, and no
mesh fields.  ``-L 1..3`` and ``-G 2..4`` are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.scan import Scan
from ..utils.metrics import metrics
from . import elch as elch_mod
from . import graphslam as gs
from .icp import IcpParams
from .lum_device import CorrCache
from .sequence import SequenceRegistration

__all__ = ["GraphPipeline"]

ELCH_TIME = "elch_time"


@dataclasses.dataclass
class GraphPipeline:
    icp_params: IcpParams = dataclasses.field(default_factory=IcpParams)
    metascan: bool = False
    lum_max_dist2: float = 625.0  # -D
    lum_iterations: int = 50  # -I
    lum_epsilon: float = 0.5  # --epsSLAM
    elch: bool = False  # loop closing enabled (-L > 0)
    elch_algo: int = 4  # -L: 4 slerp (1 euler, 2 quat, 3 unitQuat: not ported)
    cldist: float = 500.0
    loopsize: int = 20
    mdmll: float = -1.0  # --DlastSLAM (final pass match distance)
    graph_dist: float = -1.0  # --graphDist (final pass graph distance)
    slam_algo: int = 1  # -G: 1 lum6DEuler (2 lum6DQuat, 3 ghelix6DQ2, 4 gapx6D: not ported)
    # LUM iterations for the PER-CLOSURE relax (the reference runs
    # doGraphSlam6D(gr, allScans, 1) inside the loop, slam6D.cc:508,
    # and the full -I budget only in the final passes).  None = use
    # lum_iterations for both.
    closure_lum_iterations: int | None = None
    # relative-pose drift (cm, rad) beyond which a cached link's NN
    # correspondences are recomputed (lum_device.CorrCache)
    corr_tol_t: float = 0.5
    corr_tol_r: float = 2e-3
    device: torch.device | str | None = None  # None: the package default

    def _check_ported(self) -> None:
        if self.slam_algo not in (0, 1):
            raise NotImplementedError(
                f"-G {self.slam_algo} is not ported yet (ROADMAP slice C: "
                "graphslam_variants); -G 1 (lum6DEuler) is"
            )
        if self.elch and self.elch_algo not in elch_mod.ELCH_VARIANTS:
            raise NotImplementedError(
                f"-L {self.elch_algo} is not ported yet (ROADMAP slice C: "
                "ELCH variants 1-3); -L 4 (slerp) is"
            )

    def _lum_params(
        self, max_dist2: float, iterations: int | None = None
    ) -> "gs.LumParams":
        """LumParams carrying the sequence-wide resident tensors and the
        closure relax's correspondence cache."""
        return gs.LumParams(
            max_dist_match2=max_dist2,
            iterations=(
                self.lum_iterations if iterations is None else iterations
            ),
            epsilon=self.lum_epsilon,
            device_points=self._device_points,
            corr_cache=self._lum_corr_cache,
            device=self._device,
        )

    def _prepare_statics(self, scans) -> SequenceRegistration:
        """The one resident upload of the run, and the correspondence
        caches of the continuous-closure regime: one for the per-closure
        1-iteration LUM link set, one for the ELCH edge covariances
        (different link sets — separate slot spaces)."""
        seq = SequenceRegistration(
            params=self.icp_params, metascan=self.metascan, device=self.device
        )
        prep = seq._prepare(scans)
        self._device = prep["device"]
        self._device_points = (prep["locals"], prep["masks"])
        kw = dict(tol_t=self.corr_tol_t, tol_r=self.corr_tol_r, device=self._device)
        self._lum_corr_cache = CorrCache(prep["cap"], **kw)
        self._elch_corr_cache = CorrCache(prep["cap"], **kw)
        return seq

    def run(self, scans: list[Scan]) -> list[dict]:
        self._check_ported()
        n = len(scans)
        cld2 = self.cldist**2
        results: list[dict] = []
        edges: list[tuple[int, int]] = []
        if n == 0:
            return results
        seq = self._prepare_statics(scans)
        # closures made, as (first, last, upto), in order
        self.closures: list[tuple[int, int, int]] = []
        loop_state = 0
        min_dist = -1.0
        first = last = 0

        for i in range(1, n):
            edges.append((i - 1, i))
            # ICP step vs previous (run_single extrapolates odometry
            # and records frames globally)
            results.append(seq.run_single(scans, i))

            if loop_state == 1:
                loop_state = 2
            # loop detection (slam6D.cc:479-489): the closest scan j <
            # i - loopsize within cldist, the lowest j on ties
            if i - self.loopsize > 0:
                older = np.stack(
                    [s.transMat[:3, 3] for s in scans[: i - self.loopsize]]
                )
                d = ((older - scans[i].transMat[:3, 3]) ** 2).sum(axis=1)
                j = int(np.argmin(d))
                if d[j] < cld2:
                    loop_state = max(loop_state, 1)
                    if min_dist < 0 or d[j] < min_dist:
                        min_dist = float(d[j])
                        first, last = j, i

            if loop_state == 2:
                loop_state = 0
                min_dist = -1.0
                self._close_and_relax(scans, first, last, edges, upto=i)

        if loop_state == 1 and self.elch:
            self._close_and_relax(scans, first, last, edges, upto=n - 1)

        # final LUM passes (slam6D.cc:520-547)
        if self.lum_iterations > 0 and self.lum_max_dist2 > 0:
            self._relax(scans, self.lum_max_dist2, cld2)
        if self.mdmll > 0:
            gd2 = self.graph_dist**2 if self.graph_dist > 0 else cld2
            self._relax(scans, self.mdmll**2, gd2)
        return results

    def _close_and_relax(self, scans, first, last, edges, upto):
        self.closures.append((first, last, upto))
        if self.elch:
            with metrics.time(ELCH_TIME):
                elch_mod.ELCH_VARIANTS[self.elch_algo](
                    scans[: upto + 1],
                    first,
                    last,
                    [e for e in edges if e[1] <= upto],
                    elch_mod.ElchParams(
                        max_dist_match2=self.icp_params.max_dist_match2,
                        icp_iterations=self.icp_params.max_iterations,
                        # converge the loop ICP with the same epsilon
                        # as the sequential matches (the 1e-7 default
                        # forces max_iterations at large scan sizes)
                        icp_epsilon=self.icp_params.epsilon,
                        device_points=self._device_points,
                        corr_cache=self._elch_corr_cache,
                        device=self._device,
                    ),
                )
            edges.append((first, last))
        if self.lum_iterations > 0 and self.lum_max_dist2 > 0:
            sub = scans[: upto + 1]
            positions = np.stack([s.rPos for s in sub])
            links = gs.build_proximity_graph(
                positions, self.cldist**2, self.loopsize
            )
            gs.do_graph_slam(
                sub, links,
                self._lum_params(
                    self.lum_max_dist2,
                    iterations=self.closure_lum_iterations,
                ),
            )

    def _relax(self, scans, max_dist2, graph_cld2):
        positions = np.stack([s.rPos for s in scans])
        links = gs.build_proximity_graph(positions, graph_cld2, self.loopsize)
        self.final_links = len(links)
        gs.do_graph_slam(scans, links, self._lum_params(max_dist2))
