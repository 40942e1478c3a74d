"""Subgraph registration: the port's ``models.subgraph.subgraph_slam``
against the JAX package's on the data of
tests/test_subgraph_fixed.py::test_subgraph_slam_reduces_drift (8 scans
of one room, 4 cm odometry jitter, chunks of 4).  The JAX-reduced points
are carried into the port (``interop.scans_from_numpy``), so both
register the same points.

Bounds: equal ``chunks``, ``chunk_links`` and ``meta_links``; final
poses within 0.5 cm translation and 1e-3 on rotation entries (the
port's sequence tests' bound), both metascan levels (LUM and
``icp_only``).  A third case sends the port's metascan LUM through the
host path with chained covariances (kernel K2's plain version), as
~144k-point metascans take it on the card, by lowering ``chained_min``
(chained ICP over metascans is held by tests/test_torch_icp_chained.py's
engine tests; at this size its cell-list spec declines)."""

import functools

import numpy as np
import pytest
import torch

from tpu3dtk.models.subgraph import SubgraphParams as JParams
from tpu3dtk.models.subgraph import subgraph_slam as j_subgraph
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import graphslam as tgs
from tpu3dtk_torch.models import subgraph as tsub
from tpu3dtk_torch.utils.metrics import metrics
from tests.test_subgraph_fixed import _loop_scans


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_numpy(s):
    return {
        "identifier": s.identifier, "xyz": s.xyz,
        "reduced_local": s.reduced_local(), "transMatOrg": s.transMatOrg,
        "transMat": s.transMat, "dalignxf": s.dalignxf,
        "reduction_voxel": s.reduction_voxel,
        "reduction_nrpts": s.reduction_nrpts,
    }


@pytest.mark.parametrize("mode", ["lum", "icp_only", "lum_chained"])
def test_subgraph_slam_matches_jax(mode, monkeypatch):
    jscans, _world = _loop_scans(np.random.default_rng(42), n=8, jitter=4.0)
    tscans, _ = interop.scans_from_numpy([_as_numpy(s) for s in jscans])
    jp = JParams(
        size=4, clpairs=50, max_dist_match2=625.0, lum_max_dist2=625.0,
        lum_iterations=15, iterations=15, icp_only=mode.startswith("icp_only"),
    )
    if mode.endswith("chained"):
        # metascans here hold ~11.6k points, chunks' scans ~2.9k
        monkeypatch.setattr(tsub.gs, "LumParams",
                            functools.partial(tgs.LumParams, chained_min=4096))
    metrics.reset()
    jinfo = j_subgraph(jscans, jp)
    tinfo = tsub.subgraph_slam(tscans, interop.subgraph_params_from(vars(jp)), device="cpu")
    assert tinfo == jinfo
    assert jinfo["chunks"] == 2 and all(c > 0 for c in jinfo["chunk_links"])
    cnt = {k: int(m.total) for k, m in metrics.counters.items()}
    assert (cnt.get(tgs.CHAINED_LINK_CALLS, 0) > 0) == mode.endswith("chained"), cnt
    if mode == "lum":
        assert jinfo["meta_links"] > 0
    for a, b in zip(tscans, jscans):
        np.testing.assert_allclose(a.transMat[:3, 3], b.transMat[:3, 3], atol=0.5)
        np.testing.assert_allclose(a.transMat[:3, :3], b.transMat[:3, :3], atol=1e-3)
        assert [t for _m, t in a.frames] == [t for _m, t in b.frames]
