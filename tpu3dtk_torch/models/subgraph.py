"""Subgraph registration — the port of ``tpu3dtk.models.subgraph`` (the
reference's ``subgraphicp``, src/slam6d/subgraphicp.cc:118-225):
partition the sequence into fixed-size chunks, relax each chunk
internally with LUM over its pairs graph, then treat every chunk as ONE
rigid metascan and relax (or ICP) between the metascans — a fast,
robust pre-registration step for srr-style correction.

Both levels run on the ported machinery: ``graphslam.build_clpairs_graph``
counts each candidate link's pairs with one brute NN call (kernel K1),
``graphslam.do_graph_slam`` relaxes chunks of small scans on the device
(K1) and metascans of ``chained_min`` points or more on the host path
with chained covariances (kernel K2), and ``icp_only`` matches the
metascans with ``SequenceRegistration``, whose chained engine (K2) takes
models of that size.  The per-member application of each metascan's
correction is a host pose composition (tiny).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import math3d
from ..core.scan import Scan
from ..io.frames import AlgoType
from ..utils.metrics import metrics
from . import graphslam as gs
from .icp import IcpParams
from .sequence import SequenceRegistration

__all__ = ["SubgraphParams", "subgraph_slam"]

# metrics timers (host clocks): the chunk level, building the metascans,
# and the metascan level
SUBGRAPH_CHUNKS = "subgraph_chunk_time"
SUBGRAPH_METASCANS = "subgraph_metascan_build_time"
SUBGRAPH_META = "subgraph_meta_time"


@dataclasses.dataclass
class SubgraphParams:
    size: int = 10                 # scans per subgraph (ref --size)
    clpairs: int = 100             # min shared pairs for a graph link
    max_dist_match2: float = 625.0  # -d
    lum_max_dist2: float = 625.0   # -D
    iterations: int = 50           # -i (metascan level)
    lum_iterations: int = 25       # -I (chunk level)
    epsilon: float = 1e-5
    lum_epsilon: float = 0.5
    icp_only: bool = False         # ref --icp-only: sequential ICP over
    # the metascans instead of GraphSLAM between them
    meta_voxel: float = 0.0        # re-reduction voxel for metascans
    # (0 = keep the union as-is)


def _meta_scan(chunk: list[Scan], ident: str, voxel: float, device) -> Scan:
    """One rigid scan from a chunk: union of reduced points in the
    global frame, pose = identity (so the metascan's final transMat IS
    the correction to apply to every member), reduced on ``device``."""
    pts = np.concatenate(
        [
            np.asarray(math3d.transform3(s.transMat, s.reduced_local()))
            for s in chunk
        ]
    )
    m = Scan.from_points(pts, identifier=ident)
    m.device = str(device)
    if voxel > 0:
        m.set_reduction(voxel, 1)
    return m


def subgraph_slam(
    scans: list[Scan], params: SubgraphParams | None = None, device=None
) -> dict:
    """Run the two-level subgraph registration on ``device`` (None: the
    package default, the first card).  Mutates scan poses.  Returns
    {'chunks': n, 'chunk_links': [...], 'meta_links': L}."""
    if device is None:
        from .. import default_device

        device = default_device()
    device = torch.device(device)
    params = params or SubgraphParams()
    n = len(scans)
    chunks = [
        scans[i : i + params.size] for i in range(0, n, params.size)
    ]

    # level 1: relax each chunk over its clpairs graph
    chunk_links = []
    with metrics.time(SUBGRAPH_CHUNKS):
        for chunk in chunks:
            if len(chunk) < 2:
                chunk_links.append(0)
                continue
            links = gs.build_clpairs_graph(
                chunk, params.lum_max_dist2, params.clpairs, device=device
            )
            chunk_links.append(len(links))
            if len(links):
                gs.do_graph_slam(
                    chunk, links,
                    gs.LumParams(
                        max_dist_match2=params.lum_max_dist2,
                        iterations=params.lum_iterations,
                        epsilon=params.lum_epsilon,
                        device=device,
                    ),
                )

    # level 2: one rigid metascan per chunk
    with metrics.time(SUBGRAPH_METASCANS):
        metas = [
            _meta_scan(chunk, f"meta{ci:03d}", params.meta_voxel, device)
            for ci, chunk in enumerate(chunks)
        ]
    meta_links = 0
    with metrics.time(SUBGRAPH_META):
        if len(metas) >= 2:
            if params.icp_only:
                reg = SequenceRegistration(
                    params=IcpParams(
                        max_dist_match2=params.max_dist_match2,
                        max_iterations=params.iterations,
                        epsilon=params.epsilon,
                    ),
                    extrapolate_odometry=False,
                    device=device,
                )
                reg.run(metas)
                meta_links = len(metas) - 1
            else:
                links = gs.build_clpairs_graph(
                    metas, params.max_dist_match2, params.clpairs, device=device
                )
                meta_links = len(links)
                if len(links):
                    gs.do_graph_slam(
                        metas, links,
                        gs.LumParams(
                            max_dist_match2=params.max_dist_match2,
                            iterations=params.iterations,
                            epsilon=params.lum_epsilon,
                            device=device,
                        ),
                    )

    # apply each metascan's correction to its members (the reference's
    # manual transform writeback, subgraphicp.cc:214-221)
    for chunk, meta in zip(chunks, metas):
        delta = meta.transMat  # pose started at identity
        for s in chunk:
            s.set_pose(delta @ s.transMat, AlgoType.ICP)
    return {
        "chunks": len(chunks),
        "chunk_links": chunk_links,
        "meta_links": int(meta_links),
    }
