"""The chained cell-list ICP engine of the port (kernel K2's plain
version on the CPU) against the JAX package's (Pallas K2 in interpret
mode), and the engine choice of SequenceRegistration.

Bounds:
- ``icp_pair_chained`` against JAX's chained result on one pair: pose
  within 0.01 cm and 1e-6 on rotation entries, iterations within 3.  Both
  run the same f32 update on (nearly) the same pairs; the JAX kernel's
  split ranking may swap a few near-equidistant candidates and the f32
  pair-statistics sums run in another order, which moves the late pose
  increments near the 1e-2 cm fixpoint threshold and with them the stop
  (the reason ROADMAP gives for metascan matches).
- the port's chained engine against its own brute engine: both are
  exact, so poses agree to 0.01 cm / 1e-6 and iterations within 1.
- ``SequenceRegistration`` against the JAX package's (which, off a TPU,
  registers through its brute engine): the bounds of
  tests/test_torch_sequence.py, 0.5 cm / 1e-3 and iterations ±1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dtk.core import math3d as jmath
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.models import icp as jicp
from tpu3dtk.models.sequence import SequenceRegistration as JSeq
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import icp as ticp
from tpu3dtk_torch.models import sequence as tseq
from tpu3dtk_torch.synth import synth_loop
from tpu3dtk_torch.utils.metrics import metrics


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run has six test processes, and
    eight spinning threads each slow every process on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng):
    # tests/test_nn_pallas.py:106-130
    world = rng.uniform(0, 400, (5000, 3)).astype(np.float32)
    T_true = np.asarray(
        jmath.euler_to_matrix4([6.0, -4.0, 5.0], [0.01, -0.02, 0.015])
    )
    target = np.asarray(
        jmath.transform3(jmath.m4inv(T_true), world)
    ).astype(np.float32)
    return world, target, T_true


def test_icp_pair_chained_matches_jax(rng):
    world, target, T_true = _pair(rng)
    kw = dict(max_dist_match2=625.0, epsilon=1e-7, max_iterations=40)
    jres = jicp.icp_pair_chained(
        jnp.asarray(world), jnp.ones(len(world), bool), jnp.asarray(target),
        jnp.ones(len(target), bool), jnp.eye(4, dtype=jnp.float32), **kw,
    )
    metrics.reset()
    tres = ticp.icp_pair_chained(
        torch.as_tensor(world), torch.ones(len(world), dtype=torch.bool),
        torch.as_tensor(target), torch.ones(len(target), dtype=torch.bool),
        torch.eye(4), **kw,
    )
    assert int(jres.maxocc) == 0 and tres.maxocc == 0  # guards stayed green
    Tj, Tt = np.asarray(jres.T, np.float64), tres.T.double().numpy()
    np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], atol=0.01)
    np.testing.assert_allclose(Tt[:3, :3], Tj[:3, :3], atol=1e-6)
    np.testing.assert_allclose(Tt, T_true, atol=0.5)
    assert abs(tres.iterations - int(jres.iterations)) <= 3
    assert tres.error == pytest.approx(float(jres.error), abs=1e-3)
    assert tres.n_pairs == float(jres.n_pairs)
    # loop trips are polled every 4th: a multiple of 4 (or the cap), and
    # at least the reported iterations
    trips = int(metrics.counters[ticp.CHAINED_TRIPS].total)
    assert trips >= tres.iterations and (trips % 4 == 0 or trips == 40)
    # the port's brute engine on the same pair: both exact
    bres = ticp.icp_pair(
        torch.as_tensor(world), torch.ones(len(world), dtype=torch.bool),
        torch.as_tensor(target), torch.ones(len(target), dtype=torch.bool),
        torch.eye(4), **kw,
    )
    Tb = bres.T.double().numpy()
    np.testing.assert_allclose(Tt[:3, 3], Tb[:3, 3], atol=0.01)
    np.testing.assert_allclose(Tt[:3, :3], Tb[:3, :3], atol=1e-6)
    assert abs(tres.iterations - bres.iterations) <= 1


def test_chained_engines_run_without_clamp_and_lane(rng):
    """The chained ICP and LUM link engines on a spec whose RB is far
    below the chunks' candidate ranges: the port has no clamp and no
    lane, RB limits nothing, so the poses stay those of the brute engine
    (both exact: 0.01 cm / 1e-6, iterations within 1) and the link sums
    are the brute engine's."""
    from tpu3dtk_torch.models import graphslam as tgs
    from tpu3dtk_torch.ops import nn_cell_list as ncl

    world, target, _ = _pair(rng)
    spec = dict(ncl.cell_list_spec(world, 25.0, device="cpu"), RB=128)
    args = (
        torch.as_tensor(world), torch.ones(len(world), dtype=torch.bool),
        torch.as_tensor(target), torch.ones(len(target), dtype=torch.bool),
        torch.eye(4),
    )
    kw = dict(max_dist_match2=625.0, epsilon=1e-7, max_iterations=40)
    tres = ticp.icp_pair_chained(*args, spec=spec, **kw)
    bres = ticp.icp_pair(*args, **kw)
    assert tres.maxocc == 0
    Tt, Tb = tres.T.double().numpy(), bres.T.double().numpy()
    np.testing.assert_allclose(Tt[:3, 3], Tb[:3, 3], atol=0.01)
    np.testing.assert_allclose(Tt[:3, :3], Tb[:3, :3], atol=1e-6)
    assert abs(tres.iterations - bres.iterations) <= 1
    # the LUM link engine on the same route: the brute engine's sums
    pts = torch.stack([args[0], ticp._chain_transform(bres.T, args[2])])
    masks = torch.ones(pts.shape[:2], dtype=torch.bool)
    links = np.asarray([[0, 1], [1, 0]])
    spec2 = dict(ncl.cell_list_spec(pts.reshape(-1, 3), 25.0), RB=128)
    C, CD, m, guard = tgs.link_covariances_chained(pts, masks, links, 625.0, spec2)
    bC, bCD, bm = tgs.link_covariances(pts, masks, links, 625.0)
    assert not guard
    np.testing.assert_array_equal(m, bm.numpy())
    np.testing.assert_allclose(C, bC.numpy(), rtol=1e-6)
    np.testing.assert_allclose(CD, bCD.numpy(), rtol=1e-6, atol=1e-6)


def test_link_guard_fires_on_a_target_point_outside_the_box(rng):
    """``link_covariances_chained``'s guard: green when every point lies
    in the spec's grid box; fired when a masked-in target point of a link
    leaves it; green again when that point is masked out."""
    from tpu3dtk_torch.models import graphslam as tgs
    from tpu3dtk_torch.ops import nn_cell_list as ncl

    world, target, T_true = _pair(rng)
    pts = torch.stack([torch.as_tensor(world), ticp._chain_transform(
        torch.as_tensor(T_true, dtype=torch.float32), torch.as_tensor(target))])
    masks = torch.ones(pts.shape[:2], dtype=torch.bool)
    links = np.asarray([[0, 1]])
    spec = ncl.cell_list_spec(pts.reshape(-1, 3), 25.0)
    assert spec is not None
    assert not tgs.link_covariances_chained(pts, masks, links, 625.0, spec)[3]
    far = pts.clone()
    far[1, 7] += 1e5  # far outside the box
    assert tgs.link_covariances_chained(far, masks, links, 625.0, spec)[3]
    masks[1, 7] = False
    assert not tgs.link_covariances_chained(far, masks, links, 625.0, spec)[3]


def test_chain_update_freezes_pose_once_done(rng):
    """After ``done`` the pose stays and the iteration count stops."""
    world, target, _ = _pair(rng)
    model = torch.as_tensor(world[:500])
    tgt = torch.as_tensor(world[:500] + np.float32(0.5))
    idx = torch.arange(500)
    found = torch.ones(500, dtype=torch.bool)
    inf = torch.full((), float("inf"), dtype=torch.float64)
    T = torch.eye(4)
    for done, want_n in ((False, 1), (True, 0)):
        conv = (inf, inf, inf, torch.tensor(done), torch.zeros((), dtype=torch.int32))
        T2, conv2, n = ticp._chain_update_conv(
            model, idx, found, tgt, T, conv, 1e-7, ticp.mz.align_quat
        )
        assert int(conv2[4]) == want_n and float(n) == 500.0
        assert torch.equal(T2, T) is done
        assert conv2[0].dtype == torch.float64
    # fewer than 4 pairs: done, pose kept
    conv = (inf, inf, inf, torch.tensor(False), torch.zeros((), dtype=torch.int32))
    few = torch.zeros(500, dtype=torch.bool)
    few[:3] = True
    T2, conv2, n = ticp._chain_update_conv(
        model, idx, few, tgt, T, conv, 1e-7, ticp.mz.align_quat
    )
    assert bool(conv2[3]) and torch.equal(T2, T) and float(n) == 3.0


def _scans(n_scans=4, n_pts=4000, seed=5):
    # the first scans of a 60-scan loop: ~1.25 m apart, well overlapping
    locs, _true, odo = synth_loop(n_scans=60, n_pts=n_pts, seed=seed)
    jscans = []
    for k, (loc, To) in enumerate(zip(locs[:n_scans], odo[:n_scans])):
        s = TPUScan.from_points(loc, f"{k:03d}", To)
        s.set_reduction(10.0, 1)
        s.reduced_local()
        jscans.append(s)
    return jscans


def _carry(jscans, params):
    return interop.scans_from_numpy(
        [
            {"identifier": s.identifier, "xyz": s.xyz,
             "reduced_local": s.reduced_local(), "transMatOrg": s.transMatOrg,
             "transMat": s.transMat, "reduction_voxel": s.reduction_voxel,
             "reduction_nrpts": s.reduction_nrpts}
            for s in jscans
        ],
        params,
    )


PARAMS = dict(max_dist_match2=2500.0, max_iterations=30, epsilon=1e-6)


def _window1_spec(scans):
    """The spec ``SequenceRegistration._chain_spec`` sizes for window-1
    matching, without its 9·RB < window gate: at test size a chunk of 256
    queries spans a large part of a 4000-point scan (9·RB > 4000), so the gate (rightly)
    declines and the test sets the spec by hand to drive the engine."""
    from tpu3dtk_torch.ops import nn_cell_list as ncl

    clouds = [s.reduced_global().astype(np.float32) for s in scans]
    return ncl.cell_list_spec(
        clouds, 50.0, headroom=2.0, model_sets=clouds, queries=clouds,
        pairs=[(i - 1, i) for i in range(1, len(clouds))], device="cpu",
    )


@pytest.mark.parametrize("metascan", [False, True])
def test_sequence_chained_engine(metascan):
    """A small ``chained_min`` sends every match through the chained
    engine: same poses as the port's brute engine and as the JAX
    package's SequenceRegistration."""
    jscans = _scans(n_pts=5000 if metascan else 4000)
    a, params = _carry(jscans, PARAMS)
    b, _ = _carry(jscans, PARAMS)
    metrics.reset()
    reg = tseq.SequenceRegistration(
        params=params, metascan=metascan, device="cpu", chained_min=512
    )
    prep = reg._prepare(a)
    if metascan:
        assert prep["chain_spec"] is not None  # 9·RB < 4 scans x cap
    else:
        assert prep["chain_spec"] is None  # the gate declines: see _window1_spec
        prep["chain_spec"] = _window1_spec(a)
    res_c = reg.run(a)
    n_chain = int(metrics.counters[tseq.CHAINED_MATCHES].total)
    assert n_chain == len(a) - 1
    assert int(metrics.counters[tseq.CHAINED_REDONE].total) == 0
    assert int(metrics.counters[ticp.CHAINED_TRIPS].total) >= sum(
        r["iterations"] for r in res_c
    )
    metrics.reset()
    brute = tseq.SequenceRegistration(params=params, metascan=metascan, device="cpu")
    res_b = brute.run(b)
    assert brute._prep["chain_spec"] is None  # default chained_min: out of reach
    assert not metrics.counters[tseq.CHAINED_MATCHES].count
    jres = JSeq(
        params=jicp.IcpParams(**PARAMS), metascan=metascan, mesh=None
    ).run(jscans)
    slack = 3 if metascan else 1  # tests/test_torch_sequence.py docstring
    for rc, rb, rj in zip(res_c, res_b, jres):
        assert abs(rc["iterations"] - rb["iterations"]) <= 1
        assert abs(rc["iterations"] - rj["iterations"]) <= slack
        assert rc["error"] == pytest.approx(rb["error"], abs=1e-3)
        assert rc["pairs"] == rb["pairs"]
    for x, y, j in zip(a, b, jscans):
        np.testing.assert_allclose(x.transMat[:3, 3], y.transMat[:3, 3], atol=0.01)
        np.testing.assert_allclose(x.transMat[:3, :3], y.transMat[:3, :3], atol=1e-6)
        np.testing.assert_allclose(x.transMat[:3, 3], j.transMat[:3, 3], atol=0.5)
        np.testing.assert_allclose(x.transMat[:3, :3], j.transMat[:3, :3], atol=1e-3)
        assert [f[1] for f in x.frames] == [f[1] for f in y.frames] == [
            f[1] for f in j.frames
        ]


def test_fired_guard_redoes_with_brute():
    """A scan whose odometry pose lies outside the grid box the spec was
    sized with fires the out-of-box guard after extrapolation... here the
    box is made too small on purpose: the match is redone with brute and
    gives the brute engine's poses."""
    jscans = _scans(n_scans=3)
    a, params = _carry(jscans, PARAMS)
    b, _ = _carry(jscans, PARAMS)
    reg = tseq.SequenceRegistration(params=params, device="cpu", chained_min=512)
    prep = reg._prepare(a)
    spec = dict(_window1_spec(a))
    spec["dims"] = (spec["dims"][0] // 2, spec["dims"][1], spec["dims"][2])
    prep["chain_spec"] = spec  # half the box along one axis: points fall outside
    metrics.reset()
    reg.run(a)
    assert int(metrics.counters[tseq.CHAINED_MATCHES].total) == 2
    assert int(metrics.counters[tseq.CHAINED_REDONE].total) == 2
    tseq.SequenceRegistration(params=params, device="cpu").run(b)
    # the same brute matches; run_single carries the poses through the
    # host in f64 between matches, the device loop keeps them in f32
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.transMat[:3, 3], y.transMat[:3, 3], atol=0.01)
        np.testing.assert_allclose(x.transMat[:3, :3], y.transMat[:3, :3], atol=1e-6)
        assert len(x.frames) == len(y.frames)


def _jax_spec(points, max_dist, device=None, **kw):
    """The JAX package's spec on the same clouds, as numpy arrays."""
    def host(c):
        return c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)

    from tpu3dtk.ops import nn_pallas as npl

    pieces = points if isinstance(points, (list, tuple)) else [points]
    for k in ("model_sets", "queries"):
        if kw.get(k) is not None:
            kw[k] = [host(c) for c in kw[k]]
    return npl.cell_list_spec(np.concatenate([host(p) for p in pieces]), max_dist, **kw)


def test_sequence_and_host_lum_equal_a_run_on_the_jax_spec(monkeypatch):
    """A chained ``SequenceRegistration.run`` and then a host
    ``do_graph_slam`` over the chain and its closing link, on specs the
    port sizes and on specs the JAX package sizes: the same specs, so
    the same poses and frames, bit for bit."""
    from tpu3dtk_torch.models import graphslam as tgs
    from tpu3dtk_torch.ops import nn_cell_list as ncl

    jscans = _scans(n_pts=5000)
    links = np.array([[0, 1], [1, 2], [2, 3], [0, 3]], np.int32)
    lum = tgs.LumParams(
        max_dist_match2=2500.0, iterations=3, epsilon=1e-3, chained_min=512, device="cpu"
    )

    def run(spec_fn):
        scans, params = _carry(jscans, PARAMS)
        seen = []

        def spec(*a, **kw):
            seen.append(spec_fn(*a, **kw))
            return seen[-1]

        monkeypatch.setattr(ncl, "cell_list_spec", spec)
        metrics.reset()
        tseq.SequenceRegistration(
            params=params, metascan=True, device="cpu", chained_min=512
        ).run(scans)
        tgs.do_graph_slam(scans, links, lum)
        assert int(metrics.counters[tseq.CHAINED_MATCHES].total) == len(scans) - 1
        assert int(metrics.counters[tgs.CHAINED_LINK_CALLS].total) > 0
        return scans, seen

    port, port_specs = run(ncl.cell_list_spec)
    jax_run, jax_specs = run(_jax_spec)
    assert len(port_specs) == len(jax_specs) == 2
    for got, want in zip(port_specs, jax_specs):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    for x, y in zip(port, jax_run):
        np.testing.assert_array_equal(x.transMat, y.transMat)
        assert len(x.frames) == len(y.frames)
        for (tx, kx), (ty, ky) in zip(x.frames, y.frames):
            np.testing.assert_array_equal(tx, ty)
            assert kx == ky


# ---------------------------------------------------------------------------
# The chained loop's trip as one function, and its CUDA graph path's
# control flow on the CPU
# ---------------------------------------------------------------------------


def _unfactored_icp_pair_chained(model, mmask, target_local, tmask, T0, *, max_dist_match2,
                                 epsilon, max_iterations, spec, minimizer="quat", check_every=4):
    """``icp_pair_chained``'s loop written out step by step, as it stood
    before its trip became one function: the reference of the factoring.
    Returns the result and the loop trips."""
    from tpu3dtk_torch.ops import nn_cell_list as ncl

    align_fn = ticp.mz.get_minimizer(minimizer)
    model = model.to(torch.float32).contiguous()
    T = torch.as_tensor(T0, dtype=torch.float32)
    max_dist = float(np.sqrt(max_dist_match2))
    perm = tuple(spec["perm"])
    clm, oob_m = ncl.build_cell_list_model(model, mmask, spec["origin"], max_dist,
                                           dims=spec["dims"], perm=perm)
    md2 = float(np.float32(max_dist_match2))
    guard = torch.zeros((), dtype=torch.int32)
    npairs = torch.zeros((), dtype=torch.float32)
    big = torch.full((), float("inf"), dtype=torch.float64)
    conv = (big, big, big, torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.int32))
    trips = 0
    for it in range(max_iterations):
        tgt_g = ticp._chain_transform(T, target_local)
        idx, _d2, found, oob_q = ncl.nn_cell_list_chained(
            tgt_g, tmask, clm, md2, dims=spec["dims"], chunk=spec["chunk"], perm=perm)
        trips += 1
        T, conv, npairs = ticp._chain_update_conv(
            model, idx, found, tgt_g, T, conv, float(epsilon), align_fn)
        guard = torch.maximum(guard, oob_q + oob_m)
        if (it + 1) % check_every == 0 or it == max_iterations - 1:
            if int(guard) > 0 or bool(conv[3]):
                break
    res = ticp.IcpResult(T=T, error=float(conv[0]), iterations=int(conv[4]),
                         n_pairs=float(npairs), maxocc=int(guard))
    return res, trips


def _plane(n, seed):
    """n points of a noisy 400 x 400 cm plane, and the same points 15 cm
    off: ICP slides there slowly (24 iterations at n = 2000)."""
    rng = np.random.default_rng(seed)
    world = np.zeros((n, 3), np.float32)
    world[:, :2] = rng.uniform(0, 400, (n, 2))
    world[:, 2] = rng.normal(0, 1.0, n)
    return world, world - np.float32([14.0, 6.0, 0.5])


def _assert_same_chained(a, b):
    assert torch.equal(a.T, b.T)
    assert (a.error, a.iterations, a.n_pairs, a.maxocc) == (b.error, b.iterations, b.n_pairs,
                                                            b.maxocc)


@pytest.mark.parametrize("stop", ["converged", "max_iterations", "guard"])
def test_chained_trip_loop_equals_the_unfactored_loop(rng, stop):
    """``icp_pair_chained`` on the CPU runs ``_chained_trip`` in the
    host's polling loop: the same pose, error, iterations, pairs, guard
    and loop trips as the unfactored loop.  Cases: a match that
    converges; one stopped at ``max_iterations`` = 10, not a multiple of
    the polling interval 4 (it would need ~24); one whose grid-box guard
    fires (a target point 10^5 cm out)."""
    from tpu3dtk_torch.ops import nn_cell_list as ncl
    from tpu3dtk_torch.utils.metrics import CHAINED_GRAPH_REPLAYS

    if stop == "max_iterations":
        world, target = _plane(2000, 3)
        T0 = np.eye(4, dtype=np.float32)
    else:
        world, target, T_true = _pair(rng)
        T0 = np.asarray(T_true, np.float32) @ np.asarray(
            jmath.euler_to_matrix4([1.5, -1.0, 0.5], [0.0, 0.0, 0.0]), np.float32)
    if stop == "guard":
        target = target.copy()
        target[11] += 1e5
    kw = dict(max_dist_match2=625.0, epsilon=1e-7,
              max_iterations=10 if stop == "max_iterations" else 50)
    args = (torch.as_tensor(world), torch.ones(len(world), dtype=torch.bool),
            torch.as_tensor(target), torch.ones(len(target), dtype=torch.bool),
            torch.as_tensor(T0))
    spec = ncl.cell_list_spec(world, 25.0, device="cpu")
    ref, ref_trips = _unfactored_icp_pair_chained(*args, spec=spec, **kw)
    trips, reps = (metrics.counters[k].total for k in (ticp.CHAINED_TRIPS, CHAINED_GRAPH_REPLAYS))
    got = ticp.icp_pair_chained(*args, spec=spec, **kw)
    _assert_same_chained(got, ref)
    assert metrics.counters[ticp.CHAINED_TRIPS].total == trips + ref_trips
    assert metrics.counters[CHAINED_GRAPH_REPLAYS].total == reps  # the CPU runs eagerly
    if stop == "converged":
        assert got.maxocc == 0 and 2 < got.iterations < 50 and ref_trips % 4 == 0
    elif stop == "max_iterations":
        assert got.maxocc == 0 and got.iterations == ref_trips == 10
    else:
        assert got.maxocc > 0 and ref_trips == 4


_CUDA = torch.device("cuda")  # a device name: no card needed


@pytest.mark.parametrize("device,minimizer,graph", [
    (_CUDA, "quat", True),
    (_CUDA, "quatscale", True),
    (_CUDA, "dual", True),
    (torch.device("cpu"), "quat", False),
    (_CUDA, "svd", False),
    (_CUDA, "ortho", False),
    (_CUDA, "helix", False),
])
def test_chained_graph_path_choice(device, minimizer, graph):
    """The chained trip runs as a graph replay on a card only, and only
    for a minimizer that reads nothing from the host."""
    assert ticp._chained_graph_path(device, minimizer) is graph


_KEY_CHANGES = {
    "target_rows": lambda a: {**a, "target_local": a["target_local"][:-1]},
    "model_rows": lambda a: {**a, "clm": a["clm"]._replace(points=a["clm"].points[:-1])},
    "dims": lambda a: {**a, "dims": (a["dims"][0] + 1, *a["dims"][1:])},
    "chunk": lambda a: {**a, "chunk": 128},
    "perm": lambda a: {**a, "perm": (2, 0, 1)},
    "cell": lambda a: {**a, "clm": a["clm"]._replace(cell=a["clm"].cell * 2)},
    "md2": lambda a: {**a, "md2": 626.0},
    "eps": lambda a: {**a, "eps": 1e-6},
    "minimizer": lambda a: {**a, "minimizer": "dual"},
}


@pytest.mark.parametrize("change", sorted(_KEY_CHANGES))
def test_chained_key_holds_what_the_graph_bakes_in(rng, change):
    """The same inputs give the same key (built anew); each input a
    captured trip bakes in gives a new one when it changes."""
    from tpu3dtk_torch.ops import nn_cell_list as ncl

    world, target, _ = _pair(rng)
    spec = ncl.cell_list_spec(world, 25.0, device="cpu")
    mask = torch.ones(len(world), dtype=torch.bool)

    def inputs():
        clm, _ = ncl.build_cell_list_model(torch.as_tensor(world), mask, spec["origin"], 25.0,
                                           dims=spec["dims"], perm=spec["perm"])
        return dict(clm=clm, target_local=torch.as_tensor(target), md2=625.0, eps=1e-7,
                    minimizer="quat", dims=spec["dims"], chunk=spec["chunk"], perm=spec["perm"])

    key = ticp._chained_key(**inputs())
    assert ticp._chained_key(**inputs()) == key
    assert ticp._chained_key(**_KEY_CHANGES[change](inputs())) != key


def test_chained_and_brute_graph_caches_are_apart():
    """The chained engine's captures live in a cache of their own: filling
    either past its bound never evicts the other's entries."""
    chained, brute = ticp._CHAINED_GRAPHS, ticp._GRAPHS
    assert isinstance(chained, ticp.GraphCache) and chained is not brute
    assert chained.entries is not brute.entries and chained.seen is not brute.seen
    c, b = ticp.GraphCache(chained.cap), ticp.GraphCache(brute.cap)
    b.put("brute", "an iteration")
    for k in range(3 * c.cap):
        c.put(("chained", k), "a trip")
        assert c.recurs(("chained", k)) is False
    assert list(b.entries) == ["brute"] and not b.seen
    for k in range(3 * b.cap):
        b.put(("brute", k), "an iteration")
    assert list(c.entries) == [("chained", k) for k in range(2 * c.cap, 3 * c.cap)]


def test_captured_calls_count_a_stand_in_kernel():
    """``CapturedCalls`` keeps the count of the wrapper it is given: the
    calls made while a graph is captured launch nothing and count 0; each
    replay counts them once."""
    from tpu3dtk_torch.ops import nn_cuda
    from tpu3dtk_torch.ops.nn_cell_list_cuda import cell_list_rows_kernel

    def k2():
        k2.launches += 1

    k2.launches = 7
    k1_before, k2_before = nn_cuda.nn_brute_kernel.launches, cell_list_rows_kernel.launches
    with nn_cuda.CapturedCalls(k2) as calls:
        k2()
        k2()
    assert k2.launches == 7 and calls.calls == 2
    for n in (9, 11, 13):
        calls.replayed()
        assert k2.launches == n
    assert nn_cuda.nn_brute_kernel.launches == k1_before
    assert cell_list_rows_kernel.launches == k2_before


class _FakeTrip(ticp._CapturedTrip):
    """A captured trip without a card: the recorded trip (the trip on the
    static tensors and the copies into the static state) runs eagerly at
    each replay, which is what the graph replays."""

    made = []

    def _capture(self, kernel, record):
        import weakref

        self.record = record
        _FakeTrip.made.append(weakref.ref(self))

    @classmethod
    def first(cls, trip, clm, oob_m, target_local, tmask, state):
        return cls(trip, clm, oob_m, target_local, tmask,
                   trip(clm, oob_m, target_local, tmask, state))

    def replay(self):
        self.record()


def test_chained_graph_cache_with_a_fake_capture(rng, monkeypatch):
    """The chained graph path's control flow on the CPU, a fake capture
    in the graph's place: a key's first match runs eagerly, its second
    captures (its first trip eager), a later one loads the capture and
    replays every trip; past the cache's bound the least recently used
    capture goes.  Every match equals the eager one, trips and replays
    are counted."""
    from tpu3dtk_torch.ops import nn_cell_list as ncl
    from tpu3dtk_torch.utils.metrics import CHAINED_GRAPH_REPLAYS

    import gc

    world, target, T_true = _pair(rng)
    spec = ncl.cell_list_spec(world, 25.0, device="cpu")
    T1 = np.asarray(T_true, np.float32) @ np.asarray(
        jmath.euler_to_matrix4([1.5, -1.0, 0.5], [0.0, 0.01, 0.0]), np.float32)
    rows = {"a": 5000, "b": 4000, "c": 3000}
    kw = dict(max_dist_match2=625.0, epsilon=1e-7, max_iterations=50, spec=spec)

    def match(name, T):
        r = rows[name]
        return ticp.icp_pair_chained(
            torch.as_tensor(world), torch.ones(len(world), dtype=torch.bool),
            torch.as_tensor(target[:r]), torch.ones(r, dtype=torch.bool), torch.as_tensor(T),
            **kw)

    # (key, start, how its trips run, captures made, keys cached)
    plan = [
        ("a", T1, "eager", 0, ""), ("a", np.eye(4, dtype=np.float32), "capture", 1, "a"),
        ("a", T1, "replay", 1, "a"), ("b", T1, "eager", 1, "a"), ("b", T1, "capture", 2, "ab"),
        ("c", T1, "eager", 2, "ab"), ("c", T1, "capture", 3, "bc"), ("b", T1, "replay", 3, "cb"),
    ]
    eager, trips = [], []
    for name, T, *_ in plan:
        before = metrics.counters[ticp.CHAINED_TRIPS].total
        eager.append(match(name, T))
        trips.append(metrics.counters[ticp.CHAINED_TRIPS].total - before)

    cache = ticp.GraphCache(2)
    monkeypatch.setattr(ticp, "_CHAINED_GRAPHS", cache)
    monkeypatch.setattr(ticp, "_chained_graph_path", lambda *a: True)
    monkeypatch.setattr(ticp, "_CapturedTrip", _FakeTrip)
    monkeypatch.setattr(_FakeTrip, "made", [])
    for (name, T, how, n_made, cached), ref, n_trips in zip(plan, eager, trips):
        before, reps = (metrics.counters[k].total for k in (ticp.CHAINED_TRIPS,
                                                             CHAINED_GRAPH_REPLAYS))
        got = match(name, T)
        _assert_same_chained(got, ref)
        assert len(_FakeTrip.made) == n_made
        assert [k[1] for k in cache.entries] == [rows[c] for c in cached]
        assert metrics.counters[ticp.CHAINED_TRIPS].total == before + n_trips
        replayed = {"eager": 0, "capture": n_trips - 1, "replay": n_trips}[how]
        assert metrics.counters[CHAINED_GRAPH_REPLAYS].total == reps + replayed
        # the result's pose is not the static pose the next match loads
        assert all(got.T is not e.state.T for e in cache.entries.values())
    gc.collect()  # the fake keeps its recorded trip, which refers back to it
    assert _FakeTrip.made[0]() is None  # "a" dropped, and freed with its static tensors


def test_chained_trip_reads_nothing_from_the_host(rng, monkeypatch):
    """What a CUDA graph can hold: the chained trip makes no scalar read,
    no copy to host data and builds no tensor from host data.  K2 is a
    stand-in here (on a card it is one C call; its plain version reads
    the ranges' lengths to size its tiles); on the CPU a ``.tolist()``,
    ``.numpy()`` or ``.cpu()`` dispatches nothing, so those, and the reads
    behind a Python ``bool``, ``int`` or ``float`` of a tensor, raise."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpu3dtk_torch.ops import nn_cell_list as ncl

    world, target, T_true = _pair(rng)
    spec = ncl.cell_list_spec(world, 25.0, device="cpu")
    mask = torch.ones(len(world), dtype=torch.bool)
    clm, oob_m = ncl.build_cell_list_model(torch.as_tensor(world), mask, spec["origin"], 25.0,
                                           dims=spec["dims"], perm=spec["perm"])
    state = ticp._ChainState.start(torch.as_tensor(np.asarray(T_true, np.float32)))
    target = torch.as_tensor(target)

    def k2(table, q_sorted, model_sorted, chunk):
        return (torch.zeros(q_sorted.shape[0], dtype=torch.int32),
                torch.zeros(q_sorted.shape[0], dtype=torch.float32))

    monkeypatch.setattr(ncl, "cell_list_rows_auto", k2)

    def host_read(*a, **k):
        raise AssertionError("a host read inside the chained trip")

    for name in ("tolist", "numpy", "cpu", "item", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.name())
            return func(*args, **(kwargs or {}))

    with Ops() as ops:
        out = ticp._chained_trip(
            clm, oob_m, target, mask, state, md2=625.0, eps=1e-7,
            align_fn=ticp.mz.align_quat, dims=spec["dims"], chunk=spec["chunk"],
            perm=spec["perm"])
    assert len(ops.names) > 50 and isinstance(out, ticp._ChainState)
    assert [x.dtype for x in out] == [x.dtype for x in state]
    assert not [n for n in ops.names if n in ("aten::_local_scalar_dense", "aten::lift_fresh")]
