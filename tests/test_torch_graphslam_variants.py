"""The port's GraphSLAM variants (``tpu3dtk_torch.models.
graphslam_variants``: -G 2 quaternion LUM, -G 3 global helix, -G 4
global small angle) against the JAX package's, on the same numpy inputs
(the 8-scan drifting ring of tests/test_torch_elch.py, with 2 cm sensor
noise around a centred room: the JAX package sums the raw moments in
f32, where its quaternion residual variance cancels to rounding on
noise-free scans; the port sums in f64).

Bounds:
- ``link_raw_sums`` on the same global points: m equal, the five sums
  within 1e-4 relative to their largest entry (f32 against f64 sums).
- ``_quat_link_CCD`` on the same f64 raw sums: 1e-9 relative; links with
  m <= 2 give zero blocks; ``_helix_computeRt``: 1e-12.
- ``do_graph_slam_quat`` / ``_helix`` / ``_apx``: poses within
  0.05 cm / 1e-4 of the JAX relaxation, one LUM frame per scan and
  iteration, on the upload and the resident (``device_points``) branch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_elch import carry, loop_scans, resident
from tpu3dtk.models import graphslam as jgs
from tpu3dtk.models import graphslam_variants as jgv
from tpu3dtk_torch import interop
from tpu3dtk_torch.io.frames import AlgoType
from tpu3dtk_torch.models import graphslam as tgs
from tpu3dtk_torch.models import graphslam_variants as tgv
from tpu3dtk_torch.utils.metrics import metrics

MD2 = 2500.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The clouds here are small: one intra-op thread is faster than
    eight, and does not fight the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def ring(rng):
    jscans, true_poses = loop_scans(rng, noise=2.0, shift=400.0, n_pts=1200)
    links = jgs.build_proximity_graph(np.stack([s.rPos for s in jscans]), 1e9, 0)
    return jscans, true_poses, links


def test_link_raw_sums_match_jax(rng):
    jscans, _true, links = ring(rng)
    locals_pad, masks, mats = resident(jscans, 9)
    pts = np.einsum("sij,snj->sni", mats[:, :3, :3], locals_pad) + mats[:, None, :3, 3]
    pts = pts.astype(np.float32)
    metrics.reset()
    traw = tgv.link_raw_sums(_t(pts), _t(masks), links, MD2)
    assert metrics.counters[tgv.RAW_LINK_CALLS].total == len(links)
    jraw = jgv.link_raw_sums(jnp.asarray(pts), jnp.asarray(masks), jnp.asarray(links),
                             jnp.float32(MD2))
    for k in tgv.RAW_KEYS:
        got, want = traw[k].numpy(), np.asarray(jraw[k], np.float64)
        assert got.dtype == np.float64 and got.shape == want.shape
        if k == "m":
            np.testing.assert_array_equal(got, want)
            assert (got > 100).all()
        else:
            scale = np.abs(want).reshape(len(links), -1).max(1)
            err = np.abs(got - want).reshape(len(links), -1).max(1)
            assert (err <= 1e-4 * scale).all(), k
    empty = tgv.link_raw_sums(_t(pts), _t(masks), np.zeros((0, 2), np.int64), MD2)
    assert empty["Paa"].shape == (0, 3, 3) and empty["m"].shape == (0,)


def test_quat_blocks_and_helix_rt_match_jax(rng):
    jscans, _true, links = ring(rng)
    raw = tgv._collect_raw(carry(jscans), links, tgs.LumParams(device="cpu"))
    raw["m"][3] = 2.0  # too few pairs: zero blocks
    C, CD = tgv._quat_link_CCD(raw)
    raw_np = {k: v.numpy() for k, v in raw.items()}
    for li in range(len(links)):
        jC, jCD = jgv._quat_link_CCD(raw_np, li)
        assert np.linalg.norm(C[li].numpy() - jC) <= 1e-9 * max(np.linalg.norm(jC), 1e-300)
        assert np.linalg.norm(CD[li].numpy() - jCD) <= 1e-9 * max(np.linalg.norm(jCD), 1e-300)
    assert not C[3].any() and not CD[3].any() and C[0].abs().max() > 0
    for ccs in (rng.normal(size=6), np.r_[np.zeros(3), rng.normal(size=3)]):
        np.testing.assert_allclose(tgv._helix_computeRt(ccs), jgv._helix_computeRt(ccs),
                                   atol=1e-12)


@pytest.mark.parametrize("algo", [2, 3, 4])
@pytest.mark.parametrize("branch", ["upload", "device_points"])
def test_variants_match_jax(rng, algo, branch):
    jscans, true_poses, links = ring(rng)
    tscans = carry(jscans)
    kw = dict(max_dist_match2=MD2, iterations=5, epsilon=0.01)
    jp = jgs.LumParams(mesh=None, **kw)
    tp = interop.lum_params_from(vars(jgs.LumParams(mesh=None, **kw)))
    if branch == "device_points":
        locals_pad, masks, _m = resident(jscans, 10)  # slots beyond the scans
        jp.device_points = (jnp.asarray(locals_pad), jnp.asarray(masks))
        tp.device_points = (_t(locals_pad), _t(masks))

    def err(scans):
        return np.mean([np.linalg.norm(s.transMat[:3, 3] - T[:3, 3])
                        for s, T in zip(scans, true_poses)])

    before = err(tscans)
    metrics.reset()
    jret = jgv.GRAPHSLAM_VARIANTS[algo](jscans, links, jp)
    tret = tgv.GRAPHSLAM_VARIANTS[algo](tscans, links, tp)
    assert err(tscans) < before
    assert tret == pytest.approx(jret, abs=1e-2)
    n_it = len(tscans[0].frames)
    assert 1 <= n_it <= 5
    assert metrics.counters[tgv.RAW_LINK_CALLS].total == n_it * len(links)
    assert metrics.timers[tgs.LUM_COV].count == metrics.timers[tgs.LUM_SOLVE].count == n_it
    for t, j in zip(tscans, jscans):
        np.testing.assert_allclose(t.transMat[:3, 3], j.transMat[:3, 3], atol=0.05)
        np.testing.assert_allclose(t.transMat[:3, :3], j.transMat[:3, :3], atol=1e-4)
        assert [f[1] for f in t.frames] == [f[1] for f in j.frames] == [int(AlgoType.LUM)] * n_it


def test_variants_trivial_inputs():
    p = tgs.LumParams(device="cpu")
    for fn in tgv.GRAPHSLAM_VARIANTS.values():
        assert fn([], np.zeros((0, 2), np.int32), p) == 0.0
