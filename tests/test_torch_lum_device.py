"""The on-device LUM relaxation and the correspondence cache of the port
(``tpu3dtk_torch.models.lum_device``) against the JAX package's, on the
same numpy inputs (a 5-scan ring of a 3000-point room, reduced at 15 cm).

Bounds:
- ``_assemble_solve``: X within 1e-4 relative (of the largest entry) of
  the JAX f32 Jacobi-scaled solve on the same C/CD; the port solves in
  f64 and equals the f64 host solve to 1e-9.
- ``_ha_corrections``: 1e-5 relative (JAX f32 against f64).
- ``lum_run``: final poses within 0.05 cm / 1e-4 of the JAX f32
  relaxation, iterations within 1; one frame per scan and iteration.
- ``CorrCache.prepare``: every output equal entry for entry with the JAX
  cache over a sequence of calls (no eviction pressure).
- ``link_cov_cached`` / ``lum_step_cached`` from one cache state carried
  by ``interop.corr_cache_from_numpy``: pair counts equal, C and CD within
  1e-3 by norm, poses within 0.05 cm / 1e-4, refreshed rows equal.
- the three cases the JAX cache leaves open: empty link sets, slot
  reuse, tolerances passed by the caller.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_room_cloud
from tpu3dtk.core import math3d as jmath
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.models import graphslam as jgs
from tpu3dtk.models import lum_device as jld
from tpu3dtk_torch import interop
from tpu3dtk_torch.io.frames import AlgoType
from tpu3dtk_torch.models import graphslam as tgs
from tpu3dtk_torch.models import lum_device as tld
from tpu3dtk_torch.utils.metrics import metrics

LINKS = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [0, 4], [0, 2]], np.int32)
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


def ring_scans(rng, n=5, noise_t=3.0, noise_r=0.01):
    # tests/test_graphslam.py:29-50
    world = make_room_cloud(rng, n=3000, size=800.0)
    scans = []
    for k in range(n):
        ang = 0.25 * k
        pos = np.array([300 * np.cos(ang), 0.0, 300 * np.sin(ang)])
        T_true = np.asarray(jmath.euler_to_matrix4(pos, np.array([0.0, 0.1 * k, 0.0])))
        local = np.asarray(jmath.transform3(jmath.m4inv(T_true), world))
        T0 = T_true
        if k:
            nt = rng.uniform(-noise_t, noise_t, 3)
            nr = rng.uniform(-noise_r, noise_r, 3)
            T0 = np.asarray(jmath.euler_to_matrix4(nt, nr)) @ T_true
        s = TPUScan.from_points(local, f"{k:03d}", pose=T0)
        s.set_reduction(15.0, 1)
        s.reduced_local()
        scans.append(s)
    return scans


def resident(jscans, n_slots=None):
    """Padded [S, cap, 3] / [S, cap] numpy of the scans, S >= len(scans)."""
    cap = ((max(len(s.reduced_local()) for s in jscans) + 511) // 512) * 512
    locals_pad, masks = jgs._pad_scan_points(jscans, cap)
    extra = (n_slots or len(jscans)) - len(jscans)
    if extra:
        locals_pad = np.concatenate([locals_pad, np.zeros((extra, cap, 3), np.float32)])
        masks = np.concatenate([masks, np.zeros((extra, cap), bool)])
    return locals_pad, masks


def euler_state(jscans, S):
    pos, theta = np.zeros((S, 3)), np.zeros((S, 3))
    for si, s in enumerate(jscans):
        th, p = jmath.matrix4_to_euler(s.transMat)
        pos[si], theta[si] = p, th
    return pos, theta


def link_stats(rng):
    jscans = ring_scans(rng)
    locals_pad, masks = resident(jscans, n_slots=7)
    mats = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    mats[:5] = np.stack([s.transMat for s in jscans])
    C, CD, m = tgs.link_covariances_global(_t(locals_pad), _t(masks), _t(mats), LINKS, MD2)
    return jscans, locals_pad, masks, mats, C, CD, m


def test_link_covariances_global_matches_jax(rng):
    _s, locals_pad, masks, mats, C, CD, m = link_stats(rng)
    jC, jCD, jm = jgs.link_covariances_global(
        jnp.asarray(locals_pad), jnp.asarray(masks), jnp.asarray(mats),
        jnp.asarray(LINKS), jnp.float32(MD2),
    )
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    for k in range(len(LINKS)):
        jc, jcd = np.asarray(jC[k]), np.asarray(jCD[k])
        assert np.linalg.norm(C[k].numpy() - jc) < 1e-3 * np.linalg.norm(jc)
        assert np.linalg.norm(CD[k].numpy() - jcd) < 1e-3 * (np.linalg.norm(jcd) + 1.0)


@pytest.mark.parametrize("n_scans", [5, 4])
def test_assemble_solve_matches_jax(rng, n_scans):
    """S = 7 slots, 5 or 4 real scans, two link slots masked out, one
    link (3, 4) that lost every pair: dump row, pad blocks, empty rows."""
    *_, C, CD, _m = link_stats(rng)
    links = np.concatenate([LINKS, [[5, 6], [0, 0]]]).astype(np.int32)
    mask = np.array([True] * 6 + [False, False])
    C = torch.cat([C, torch.ones(2, 6, 6)])
    CD = torch.cat([CD, torch.ones(2, 6)])
    if n_scans == 4:  # scan 4 not real: its links are masked, its block padded
        mask[[3, 4]] = False
    jX = np.asarray(jld._assemble_solve(
        jnp.asarray(links), jnp.asarray(mask), jnp.asarray(C.numpy()), jnp.asarray(CD.numpy()),
        7, jnp.int32(n_scans),
    ))
    tX = tld._assemble_solve(links, mask, C, CD, 7, n_scans).numpy()
    assert tX.shape == jX.shape == (6, 6) and tX.dtype == np.float64
    np.testing.assert_allclose(tX, jX, atol=1e-4 * np.abs(jX).max())
    assert not tX[n_scans - 1:].any()  # padded slots get no correction
    # the same system through the f64 host solve
    valid = links[mask]
    hX = tgs._solve_GX_B(n_scans, valid, C.numpy()[mask], CD.numpy()[mask], 512)
    np.testing.assert_allclose(tX[: n_scans - 1], hX, atol=1e-9 * np.abs(hX).max())


def test_assemble_solve_empty_row_gets_identity():
    links = np.array([[0, 1], [1, 2]], np.int32)
    A = np.diag([4.0, 4, 4, 9, 9, 9])
    C = np.stack([A, np.zeros((6, 6))]).astype(np.float32)  # link (1,2) lost every pair
    CD = np.stack([np.arange(1.0, 7), np.zeros(6)]).astype(np.float32)
    mask = np.ones(2, bool)
    tX = tld._assemble_solve(links, mask, _t(C), _t(CD), 3, 3).numpy()
    jX = np.asarray(jld._assemble_solve(
        jnp.asarray(links), jnp.asarray(mask), jnp.asarray(C), jnp.asarray(CD), 3, jnp.int32(3)))
    np.testing.assert_allclose(tX, jX, atol=1e-6)
    np.testing.assert_allclose(tX[0], -np.arange(1.0, 7) / np.diag(A), atol=1e-12)
    assert not tX[1].any()


def test_ha_corrections_match_jax(rng):
    pos = rng.uniform(-500, 500, (6, 3))
    theta = rng.uniform(-1, 1, (6, 3))
    X = rng.normal(size=(6, 6))
    t = tld._ha_corrections(_t(pos), _t(theta), _t(X)).numpy()
    j = np.asarray(jld._ha_corrections(
        jnp.asarray(pos, jnp.float32), jnp.asarray(theta, jnp.float32), jnp.asarray(X, jnp.float32)))
    np.testing.assert_allclose(t, j, atol=1e-5 * np.abs(j).max())
    np.testing.assert_allclose(t, tgs.lum_pose_corrections(pos, theta, X), atol=1e-10)


@pytest.mark.parametrize("n_slots", [5, 8])
def test_lum_run_matches_jax(rng, n_slots):
    jscans = ring_scans(rng)
    locals_pad, masks = resident(jscans, n_slots)
    pos0, theta0 = euler_state(jscans, n_slots)
    links = np.concatenate([LINKS, np.zeros((2, 2), np.int32)])
    mask = np.array([True] * len(LINKS) + [False] * 2)
    jpos, jtheta, jhist, jit, jret = jld.lum_run(
        jnp.asarray(locals_pad), jnp.asarray(masks), jnp.asarray(links), jnp.asarray(mask),
        jnp.asarray(pos0, jnp.float32), jnp.asarray(theta0, jnp.float32), jnp.int32(5),
        jnp.float32(MD2), jnp.float32(1e-3), iterations=6,
    )
    seen = []
    metrics.reset()
    tpos, ttheta, tit, tret = tld.lum_run(
        _t(locals_pad), _t(masks), links, mask, pos0, theta0, 5, MD2, 1e-3,
        iterations=6, on_iteration=lambda p, t: seen.append((p.copy(), t.copy())),
    )
    assert abs(tit - int(jit)) <= 1 and len(seen) == tit
    assert int(metrics.counters[tgs.LUM_LINK_CALLS].total) == tit * len(LINKS)
    np.testing.assert_array_equal(seen[-1][0], tpos)
    np.testing.assert_allclose(tpos, np.asarray(jpos), atol=0.05)
    np.testing.assert_allclose(ttheta, np.asarray(jtheta), atol=1e-4)
    k = min(tit, int(jit)) - 1  # the history the JAX loop replays, iteration for iteration
    np.testing.assert_allclose(seen[k][0], np.asarray(jhist)[k, :, :3], atol=0.05)
    np.testing.assert_array_equal(tpos[5:], pos0[5:])  # slots beyond the real scans stay
    assert tret == pytest.approx(float(jret), abs=1e-2)


def carried_scans(jscans):
    return interop.scans_from_numpy([
        {"identifier": s.identifier, "xyz": s.xyz, "reduced_local": s.reduced_local(),
         "transMatOrg": s.transMatOrg, "transMat": s.transMat}
        for s in jscans
    ])[0]


def test_do_graph_slam_device_path_matches_jax(rng):
    """The dispatch: 5 small scans take the on-device relaxation in both
    packages; LUM frames are written as the loop goes."""
    jscans = ring_scans(rng)
    tscans = carried_scans(jscans)
    kw = dict(max_dist_match2=MD2, iterations=5, epsilon=1e-3)
    jret = jgs.do_graph_slam(jscans, LINKS, jgs.LumParams(mesh=None, **kw))
    tret = tgs.do_graph_slam(tscans, LINKS, interop.lum_params_from(
        vars(jgs.LumParams(mesh=None, **kw))))
    assert tret == pytest.approx(jret, abs=1e-2)
    for j, t in zip(jscans, tscans):
        np.testing.assert_allclose(t.transMat[:3, 3], j.transMat[:3, 3], atol=0.05)
        np.testing.assert_allclose(t.transMat[:3, :3], j.transMat[:3, :3], atol=1e-4)
        assert abs(len(t.frames) - len(j.frames)) <= 1
        assert {f[1] for f in t.frames} == {int(AlgoType.LUM)}


def test_do_graph_slam_refuses_graphs_beyond_the_dense_solve(rng):
    tscans = carried_scans(ring_scans(rng))
    with pytest.raises(NotImplementedError, match="slice C"):
        tgs.do_graph_slam(tscans, LINKS, tgs.LumParams(device="cpu", device_max_scans=4))


def cache_state(c):
    """A JAX CorrCache's state as numpy, for interop."""
    return dict(
        N=c.N, tol_t=c.tol_t, tol_r=c.tol_r, slot_cap_min=c.slot_cap_min, slots=dict(c.slots),
        L=c.L, n_refresh=c.n_refresh, n_reuse=c.n_reuse,
        idx=None if c.idx is None else np.asarray(c.idx),
        found=None if c.found is None else np.asarray(c.found),
        rel=None if c.rel is None else np.array(c.rel),
    )


def pose_sequence(rng, n=6, steps=5):
    """Pose stacks drifting by a few mm, with one larger jump."""
    mats = np.stack([
        np.asarray(jmath.euler_to_matrix4(rng.uniform(-300, 300, 3), rng.uniform(-0.5, 0.5, 3)))
        for _ in range(n)
    ])
    out = [mats]
    for k in range(steps):
        scale = 2.0 if k == 2 else 0.1
        step = np.stack([
            np.asarray(jmath.euler_to_matrix4(rng.normal(0, scale, 3), rng.normal(0, scale * 1e-3, 3)))
            for _ in range(n)
        ])
        out.append(step @ out[-1])
    return out


def test_corr_cache_prepare_equals_jax(rng):
    link_sets = [
        # growing sets (4 -> 8 slots), then subsets: a free slot is always
        # left, so the port never has to recycle one
        np.array([[0, 1], [1, 2]]), np.array([[0, 1], [1, 2], [2, 3], [0, 3]]),
        np.array([[1, 2], [2, 3], [3, 4], [0, 4], [0, 1], [0, 3]]),
        np.array([[0, 1], [4, 5], [2, 3]]),
        np.array([[0, 1], [4, 5], [2, 3], [0, 5], [1, 2]]), np.array([[0, 1]]),
    ]
    jc = jld.CorrCache(64, slot_cap_min=4)
    tc = tld.CorrCache(64, slot_cap_min=4, device="cpu")
    for links, mats in zip(link_sets, pose_sequence(rng)):
        jout = jc.prepare(links.astype(np.int64), mats)
        tout = tc.prepare(links.astype(np.int64), mats)
        for a, b in zip(tout[:3], jout[:3]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert tout[3] == jout[3]
        assert tc.slots == jc.slots and tc.L == jc.L and tc.n_evicted == 0
        assert (tc.n_refresh, tc.n_reuse) == (jc.n_refresh, jc.n_reuse)
        np.testing.assert_array_equal(tc.rel, jc.rel)
        assert tuple(tc.idx.shape) == tuple(jc.idx.shape) and tc.idx.dtype == torch.int32
    assert jc.n_reuse > 0 and jc.n_refresh > 0


def test_cached_covariances_and_step_match_jax_from_one_state(rng):
    jscans = ring_scans(rng)
    S = 6
    locals_pad, masks = resident(jscans, S)
    N = locals_pad.shape[1]
    mats64 = np.tile(np.eye(4), (S, 1, 1))
    mats64[:5] = np.stack([s.transMat for s in jscans])
    jl, jm = jnp.asarray(locals_pad), jnp.asarray(masks)

    # a first call fills the JAX cache; its state crosses to the port
    jc = jld.CorrCache(N, slot_cap_min=4)
    lp, lm, stale, n_stale = jc.prepare(LINKS[:4].astype(np.int64), mats64)
    *_, jc.idx, jc.found = jld.link_cov_cached(
        jl, jm, jnp.asarray(mats64, jnp.float32), jnp.asarray(lp), jnp.asarray(lm),
        jc.idx, jc.found, jnp.asarray(stale), jnp.int32(n_stale), jnp.float32(MD2))
    tc = interop.corr_cache_from_numpy(cache_state(jc))
    assert tc.slots == jc.slots and tc.L == jc.L == 4

    # poses move: scan 2 beyond the tolerance, the others within; two new links
    moved = mats64.copy()
    moved[2] = np.asarray(jmath.euler_to_matrix4([2.0, -1.0, 1.5], [0.004, 0.0, 0.003])) @ moved[2]
    moved[1] = np.asarray(jmath.euler_to_matrix4([0.1, 0.0, 0.1], [0.0, 1e-4, 0.0])) @ moved[1]
    moved[4] = np.asarray(jmath.euler_to_matrix4([0.1, 0.1, 0.0], [0.0, 0.0, 1e-4])) @ moved[4]
    jprep = jc.prepare(LINKS.astype(np.int64), moved)
    tprep = tc.prepare(LINKS.astype(np.int64), moved)
    for a, b in zip(tprep, jprep):
        np.testing.assert_array_equal(a, b)
    assert 0 < jprep[3] < len(LINKS)  # some refreshed, some reused
    jC, jCD, jm_, jc.idx, jc.found = jld.link_cov_cached(
        jl, jm, jnp.asarray(moved, jnp.float32), jnp.asarray(jprep[0]), jnp.asarray(jprep[1]),
        jc.idx, jc.found, jnp.asarray(jprep[2]), jnp.int32(jprep[3]), jnp.float32(MD2))
    tC, tCD, tm = tld.link_cov_cached(
        _t(locals_pad), _t(masks), _t(moved.astype(np.float32)), *tprep[:2], tc, *tprep[2:], MD2)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm_))
    slots = [jc.slots[tuple(l)] for l in LINKS.tolist()]
    np.testing.assert_array_equal(tc.found.numpy()[slots], np.asarray(jc.found)[slots])
    agree = (tc.idx.numpy()[slots] == np.asarray(jc.idx)[slots])[np.asarray(jc.found)[slots]].mean()
    assert agree >= 0.999  # both rank exactly; an exact tie may differ
    for sl in range(tc.L):
        jc_, jcd = np.asarray(jC[sl]), np.asarray(jCD[sl])
        assert np.linalg.norm(tC[sl].numpy() - jc_) <= 1e-3 * np.linalg.norm(jc_)
        assert np.linalg.norm(tCD[sl].numpy() - jcd) <= 1e-3 * (np.linalg.norm(jcd) + 1.0)
    assert not tC[~torch.as_tensor(tprep[1])].any()  # slots outside the graph stay zero

    # one cached LUM step from the (again common) state
    tc2 = interop.corr_cache_from_numpy(cache_state(jc))
    pos0, theta0 = np.zeros((S, 3)), np.zeros((S, 3))
    for si in range(5):
        th, p = jmath.matrix4_to_euler(moved[si])
        pos0[si], theta0[si] = p, th
    moved2 = np.asarray(jmath.euler_to_matrix4(pos0, theta0, xp=np))
    jprep = jc.prepare(LINKS.astype(np.int64), moved2)
    tprep = tc2.prepare(LINKS.astype(np.int64), moved2)
    assert tprep[3] == jprep[3] == 0  # nothing moved since the refresh
    jpos, jtheta, jret, jc.idx, jc.found = jld.lum_step_cached(
        jl, jm, jnp.asarray(jprep[0]), jnp.asarray(jprep[1]),
        jnp.asarray(pos0, jnp.float32), jnp.asarray(theta0, jnp.float32), jnp.int32(5),
        jnp.float32(MD2), jc.idx, jc.found, jnp.asarray(jprep[2]), jnp.int32(jprep[3]))
    tpos, ttheta, tret = tld.lum_step_cached(
        _t(locals_pad), _t(masks), *tprep[:2], pos0, theta0, 5, MD2, tc2, *tprep[2:])
    np.testing.assert_allclose(tpos, np.asarray(jpos), atol=0.05)
    np.testing.assert_allclose(ttheta, np.asarray(jtheta), atol=1e-4)
    assert tret == pytest.approx(float(jret), abs=1e-2)
    np.testing.assert_array_equal(tpos[5], pos0[5])


def test_cached_gate_is_not_strict():
    """A cached pair stays while its current distance is <= max_dist2
    (the JAX package's gate), where the NN call itself is strict."""
    pts = np.zeros((2, 4, 3), np.float32)
    pts[1, :, 0] = [10.0, 10.0, 10.0, 11.0]
    pts[0, :, 1] = pts[1, :, 1] = [0.0, 100.0, 200.0, 300.0]
    masks = np.ones((2, 4), bool)
    eye = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c = tld.CorrCache(4, device="cpu")
    prep = c.prepare(np.array([[0, 1]]), eye.astype(np.float64))
    _C, _CD, m = tld.link_cov_cached(_t(pts), _t(masks), _t(eye), *prep[:2], c, *prep[2:], 100.0)
    assert float(m[0]) == 0  # the strict NN gate finds no pair at d2 == 100
    c.found[0] = True  # pairs found earlier, at a closer pose
    prep = c.prepare(np.array([[0, 1]]), eye.astype(np.float64))
    assert prep[3] == 0
    _C, _CD, m = tld.link_cov_cached(_t(pts), _t(masks), _t(eye), *prep[:2], c, *prep[2:], 100.0)
    assert float(m[0]) == 3  # d2 == 100 stays, d2 == 121 goes


def test_corr_cache_empty_links():
    """An empty link set is a zero-slot result, not an IndexError."""
    c = tld.CorrCache(8, slot_cap_min=4, device="cpu")
    mats = np.tile(np.eye(4), (3, 1, 1))
    for empty in (np.zeros((0, 2), np.int64), np.asarray([])):
        lp, lm, stale, n_stale = c.prepare(empty, mats)
        assert lp.shape == (4, 2) and not lm.any() and n_stale == 0 and not stale.any()
    pts = torch.zeros(3, 8, 3)
    C, CD, m = tld.link_cov_cached(pts, torch.ones(3, 8, dtype=torch.bool), _t(mats).float(),
                                   lp, lm, c, stale, n_stale, 100.0)
    assert C.shape == (4, 6, 6) and not C.any() and not CD.any() and not m.any()
    assert (c.n_refresh, c.n_reuse) == (0, 0)
    with pytest.raises((IndexError, ValueError)):
        jld.CorrCache(8).prepare(np.asarray([]), mats)


def test_corr_cache_recycles_slots_of_absent_links():
    """Links that left the graph give their slots back before the
    tensors grow: L stays bounded by the largest link set."""
    c = tld.CorrCache(8, slot_cap_min=4, device="cpu")
    mats = np.tile(np.eye(4), (40, 1, 1))
    for k in range(12):  # a window of 3 links sliding along a chain
        links = np.array([[k + d, k + d + 1] for d in range(3)])
        lp, lm, stale, n_stale = c.prepare(links, mats)
        assert lm.sum() == 3 and c.L == 4
        assert n_stale == (3 if k == 0 else 1)
        for l in links.tolist():
            np.testing.assert_array_equal(lp[c.slots[tuple(l)]], l)
    assert c.n_evicted > 0 and len(c.slots) <= 4
    assert c.resident_bytes() == 4 * 8 * 5
    # a recycled slot's link is new: stale, whatever pose the slot last saw
    lp, lm, stale, n_stale = c.prepare(np.array([[0, 1], [12, 13], [13, 14]]), mats)
    assert n_stale == 1 and tuple(lp[stale[0]]) == (0, 1)
    # more links than slots: the tensors double, rows kept
    c.idx[c.slots[(12, 13)]] = 7
    c.prepare(np.array([[12, 13], [13, 14], [0, 1], [20, 21], [21, 22]]), mats)
    assert c.L == 8 and bool((c.idx[c.slots[(12, 13)]] == 7).all())
    # the JAX cache keeps every slot it ever gave out
    j = jld.CorrCache(8, slot_cap_min=4)
    for k in range(12):
        j.prepare(np.array([[k + d, k + d + 1] for d in range(3)]), mats)
    assert j.L == 16 and len(j.slots) == 14


def test_corr_cache_tolerances_are_passed(rng):
    from tpu3dtk_torch.models.graph_pipeline import GraphPipeline

    mats = np.tile(np.eye(4), (2, 1, 1))
    moved = mats.copy()
    moved[1, :3, 3] = [0.3, 0.0, 0.0]
    links = np.array([[0, 1]])
    for tol_t, want_stale in ((0.5, 0), (0.2, 1)):
        c = tld.CorrCache(8, tol_t=tol_t, device="cpu")
        c.prepare(links, mats)
        assert c.prepare(links, moved)[3] == want_stale
    rot = mats.copy()
    rot[1] = np.asarray(jmath.euler_to_matrix4(np.zeros(3), [0.0, 1e-3, 0.0]))
    for tol_r, want_stale in ((2e-3, 0), (5e-4, 1)):
        c = tld.CorrCache(8, tol_r=tol_r, device="cpu")
        c.prepare(links, mats)
        assert c.prepare(links, rot)[3] == want_stale
    d = tld.CorrCache(8, device="cpu")
    assert (d.tol_t, d.tol_r) == (jld.CorrCache(8).tol_t, jld.CorrCache(8).tol_r) == (0.5, 2e-3)
    p = GraphPipeline(corr_tol_t=0.25, corr_tol_r=1e-3, device="cpu")
    p._prepare_statics(carried_scans(ring_scans(rng, n=2)))
    for c in (p._lum_corr_cache, p._elch_corr_cache):
        assert (c.tol_t, c.tol_r) == (0.25, 1e-3)
