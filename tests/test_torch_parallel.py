"""The port's multi-process ICP and LUM (``parallel.icp_shard``,
``parallel.lum_shard``, ``parallel.distributed``) as real
``torch.distributed`` gloo jobs on localhost, one process a rank, on the
CPU: against the JAX package's unsharded ``icp_pair`` / ``lum_run`` and
against the port's own unsplit path (``group=None``), on the same seeded
inputs.

Bounds:
- a world of one: ``icp_pair_sharded``, ``icp_pair_seq_sharded`` and
  ``lum_run_sharded`` equal to ``icp_pair``, ``icp_pair_seq`` and
  ``lum_run`` bit for bit (a sum over one rank is the identity);
- two ranks: every rank ends with the same results; the LUM (its link
  statistics are summed exactly: each slot is nonzero on one rank),
  ``link_covariances_sharded`` and the host LUM path with
  ``LumParams.group`` (each rank on the chained engine for its share of
  the links) equal to the unsplit path bit for bit; the ICP (its f32
  pair sums are split in two) within 1e-3 cm / 1e-6 of the unsplit pose,
  the same subsampling draw, and one step of ``icp_step_batch_sharded``
  and a metascan match of ``icp_pair_seq_sharded`` within the same bound
  of the unsplit ones;
- the port against the JAX package: ICP within 0.5 cm / 1e-3 and the
  same pair count (tests/test_torch_icp.py's bound), LUM within 1e-3 cm
  / 1e-5 rad (tests/test_distributed.py's bound).
"""

import inspect
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
from tests.conftest import make_room_cloud
from tpu3dtk.core import math3d as jm3
from tpu3dtk.models import icp as jicp
from tpu3dtk.models.lum_device import lum_run as jlum_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as tdist
torch.set_num_threads(1)
from tpu3dtk_torch.models import graphslam as gs, icp, lum_device
from tpu3dtk_torch.parallel import distributed as dist, icp_shard, lum_shard, mesh
from tpu3dtk_torch.utils.metrics import metrics

inp, out, world = sys.argv[1], sys.argv[2], int(sys.argv[3])
if world == 1:  # a world of one, which dist.initialize() leaves alone
    tdist.init_process_group("gloo", init_method="file://" + out + ".store",
                             world_size=1, rank=0)
else:
    assert dist.initialize(device="cpu") and dist.is_distributed()
group = dist.host_device_mesh() if world > 1 else tdist.group.WORLD
m = mesh.make_mesh(group)
assert (m.size, m.rank) == (world, int(os.environ.get("PROC_ID", "0")))
P = np.load(inp)
t = lambda k: torch.as_tensor(P[k])
res = {}
for name in ("quat", "svd"):
    for sub in (1, 2):
        tgt = t("target")[: int(P["n_target"])]
        kw = dict(max_dist_match2=625.0, epsilon=1e-7, max_iterations=60, minimizer=name,
                  subsample=sub, seed=3)
        r = icp_shard.icp_pair_sharded(group, t("model"), t("mmask"), tgt,
                                       t("tmask")[: len(tgt)], t("T0"), **kw)
        res[f"icp_{name}_{sub}"] = r.T.numpy()
        res[f"icp_{name}_{sub}_it"] = np.array([r.iterations, r.n_pairs, r.error])
        if world == 1:
            u = icp.icp_pair(t("model"), t("mmask"), tgt, t("tmask")[: len(tgt)], t("T0"), **kw)
            assert torch.equal(u.T, r.T) and (u.iterations, u.n_pairs, u.error) == (
                r.iterations, r.n_pairs, r.error), name
Ts, errs, ns = icp_shard.icp_step_batch_sharded(
    group, t("model")[None], t("mmask")[None], t("target")[None], t("tmask")[None],
    t("T0")[None], max_dist_match2=625.0)
res["step"] = Ts[0].numpy()
links = P["links"]
lk = dict(iterations=5)
pos, theta, it, ret = lum_shard.lum_run_sharded(
    group, t("locals"), t("masks"), links, np.ones(len(links), bool), P["pos0"], P["theta0"],
    len(P["locals"]), 625.0, 1e-4, **lk)
res["pos"], res["theta"], res["lum_it"] = pos, theta, np.array([it, ret])
pg = gs.global_points(t("locals"), t("mats"))
C, CD, mm = lum_shard.link_covariances_sharded(group, pg, t("masks"), links, 625.0)
res["C"], res["CD"], res["m"] = C, CD, mm
seq_kw = dict(max_iterations=40, window_cap=2)
r = icp_shard.icp_pair_seq_sharded(group, t("locals"), t("masks"), t("mats"), 0, 2, 2,
                                   t("mats")[2], 625.0, 1e-7, 0, **seq_kw)
res["seq"] = r.T.numpy()
if world == 1:
    u = icp.icp_pair_seq(t("locals"), t("masks"), t("mats"), 0, 2, 2, t("mats")[2], 625.0,
                         1e-7, 0, **seq_kw)
    assert torch.equal(u.T, r.T) and (u.iterations, u.n_pairs, u.error) == (
        r.iterations, r.n_pairs, r.error)
metrics.reset()
res["host"] = host_lum(None if world == 1 else group, P)
res["host_chained"] = np.array(metrics.counters[gs.CHAINED_LINK_CALLS].total)
if world == 1:
    u = lum_device.lum_run(t("locals"), t("masks"), links, np.ones(len(links), bool),
                           P["pos0"], P["theta0"], len(P["locals"]), 625.0, 1e-4, **lk)
    assert np.array_equal(u[0], pos) and np.array_equal(u[1], theta) and u[2:] == (it, ret)
lo, hi = dist.host_scan_range(7)
res["range"] = np.array([lo, hi])
res["allsum"] = dist.allsum_hosts(group, np.full(3, m.rank + 1.0))
res["gathered"] = dist.global_scan_array(group, np.full((2, 3), float(m.rank))).numpy()
np.savez(out, **res)
tdist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_job(tmp_path, inp, world):
    port = _free_port()
    procs, outs = [], []
    for rank in range(world):
        out = str(tmp_path / f"w{world}_r{rank}.npz")
        env = dict(os.environ, JAX_COORDINATOR=f"localhost:{port}", NPROC=str(world),
                   PROC_ID=str(rank), PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, inp, out, str(world)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
        outs.append(out)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """One seeded ICP pair (a 3001-point target: the 2-rank split pads it)
    and tests/helpers/dist_lum_worker.py's 4-scan LUM problem."""
    rng = np.random.default_rng(42)
    cloud = make_room_cloud(rng, n=3006).astype(np.float32)[:3001]
    model = np.zeros((4096, 3), np.float32)
    model[: len(cloud)] = cloud
    mmask = np.arange(4096) < len(cloud)
    T0 = np.asarray(jm3.euler_to_matrix4([6.0, -4.0, 3.0], [0.02, -0.01, 0.015]), np.float32)

    world = make_room_cloud(np.random.default_rng(0), n=1200, size=600.0)
    S = 4
    locals_ = np.zeros((S, len(world), 3), np.float32)
    pos0 = np.zeros((S, 3), np.float32)
    theta0 = np.zeros((S, 3), np.float32)
    jit_rng = np.random.default_rng(1)
    mats = np.zeros((S, 4, 4), np.float32)
    for k in range(S):
        pos_true = np.array([40.0 * k, 0.0, 0.0])
        T = np.asarray(jm3.euler_to_matrix4(pos_true, np.zeros(3)))
        locals_[k] = np.asarray(jm3.transform3(np.asarray(jm3.m4inv(T)), world))
        pos0[k] = pos_true + (jit_rng.normal(0, 2.0, 3) if k else 0.0)
        mats[k] = np.asarray(jm3.euler_to_matrix4(pos0[k], theta0[k]))
    links = np.array([(i, i + 1) for i in range(S - 1)] + [(0, S - 1), (0, 2)], np.int32)
    P = dict(model=model, mmask=mmask, target=model, tmask=mmask, n_target=len(cloud),
             T0=T0, locals=locals_, masks=np.ones(locals_.shape[:2], bool), pos0=pos0,
             theta0=theta0, links=links, mats=mats)
    path = str(tmp_path_factory.mktemp("par") / "problem.npz")
    np.savez(path, **P)
    return path, P


def host_lum(group, P):
    """The host LUM path (``LumParams.chained_min`` 1: the chained link
    engine) on the problem's scans, the links split over ``group``:
    the final poses [S,4,4]."""
    from tpu3dtk_torch.core.scan import Scan
    from tpu3dtk_torch.models import graphslam as gs

    scans = [Scan.from_points(loc, f"{k:03d}", pose=T)
             for k, (loc, T) in enumerate(zip(P["locals"], P["mats"]))]
    gs.do_graph_slam(scans, P["links"], gs.LumParams(
        max_dist_match2=625.0, iterations=3, epsilon=1e-4, chained_min=1, device="cpu",
        group=group))
    return np.stack([s.transMat for s in scans])


# the worker script: host_lum, then the job
WORKER = inspect.getsource(host_lum) + _WORKER


def _unsplit(P):
    """The port's unsplit results on the problem (group=None)."""
    import torch

    from tpu3dtk_torch.models import graphslam as gs
    from tpu3dtk_torch.models import icp, lum_device

    t = lambda k: torch.as_tensor(P[k])  # noqa: E731
    n = P["n_target"]
    out = {}
    for name in ("quat", "svd"):
        for sub in (1, 2):
            r = icp.icp_pair(t("model"), t("mmask"), t("target")[:n], t("tmask")[:n], t("T0"),
                             max_dist_match2=625.0, epsilon=1e-7, max_iterations=60,
                             minimizer=name, subsample=sub, seed=3)
            out[f"icp_{name}_{sub}"] = r.T.numpy()
            out[f"icp_{name}_{sub}_it"] = np.array([r.iterations, r.n_pairs, r.error])
    out["step"] = icp.icp_pair(t("model"), t("mmask"), t("target"), t("tmask"), t("T0"),
                               max_dist_match2=625.0, epsilon=1e-7, max_iterations=1).T.numpy()
    links = P["links"]
    pos, theta, it, ret = lum_device.lum_run(
        t("locals"), t("masks"), links, np.ones(len(links), bool), P["pos0"], P["theta0"],
        len(P["locals"]), 625.0, 1e-4, iterations=5)
    out["pos"], out["theta"], out["lum_it"] = pos, theta, np.array([it, ret])
    C, CD, m = gs.link_covariances(gs.global_points(t("locals"), t("mats")), t("masks"), links, 625.0)
    out["C"], out["CD"], out["m"] = C.numpy(), CD.numpy(), m.numpy()
    out["seq"] = icp.icp_pair_seq(t("locals"), t("masks"), t("mats"), 0, 2, 2, t("mats")[2], 625.0,
                                  1e-7, 0, max_iterations=40, window_cap=2).T.numpy()
    out["host"] = host_lum(None, P)
    return out


def test_world_of_one_is_the_unsplit_path(problem, tmp_path):
    """The worker itself asserts icp_pair_sharded == icp_pair and
    lum_run_sharded == lum_run bit for bit in a world of one."""
    path, P = problem
    (r,) = _run_job(tmp_path, path, 1)
    u = _unsplit(P)
    for k in ("pos", "theta", "lum_it", "C", "CD", "m", "icp_quat_1", "icp_svd_2", "step", "seq",
              "host"):
        np.testing.assert_array_equal(r[k], u[k], err_msg=k)
    assert r["host_chained"] == 3 * len(P["links"])  # the host path ran the chained engine
    np.testing.assert_array_equal(r["range"], [0, 7])
    np.testing.assert_array_equal(r["allsum"], [1.0, 1.0, 1.0])


def test_two_ranks_match_unsplit_and_jax(problem, tmp_path):
    path, P = problem
    r0, r1 = _run_job(tmp_path, path, 2)
    for k in r0:
        if k not in ("range", "host_chained"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=f"ranks differ: {k}")
    np.testing.assert_array_equal([r0["range"], r1["range"]], [[0, 4], [4, 7]])
    np.testing.assert_array_equal(r0["allsum"], [3.0, 3.0, 3.0])
    np.testing.assert_array_equal(r0["gathered"], np.repeat([[0.0], [1.0]], 2, axis=0) * np.ones(3))
    u = _unsplit(P)
    for k in ("pos", "theta", "lum_it", "C", "CD", "m", "host"):
        np.testing.assert_array_equal(r0[k], u[k], err_msg=k)
    # each rank ran the chained engine on its share of the links
    lo = -(-len(P["links"]) // 2)
    assert (r0["host_chained"], r1["host_chained"]) == (3 * lo, 3 * (len(P["links"]) - lo))
    for k in ("icp_quat_1", "icp_quat_2", "icp_svd_1", "icp_svd_2", "step", "seq"):
        np.testing.assert_allclose(r0[k][:3, 3], u[k][:3, 3], atol=1e-3, err_msg=k)
        np.testing.assert_allclose(r0[k][:3, :3], u[k][:3, :3], atol=1e-6, err_msg=k)
    for k in ("icp_quat_1", "icp_quat_2", "icp_svd_1", "icp_svd_2"):
        assert r0[k + "_it"][1] == u[k + "_it"][1], k  # the same pairs found

    # against the JAX package's unsharded paths
    n = P["n_target"]
    jr = jicp.icp_pair(
        jnp.asarray(P["model"]), jnp.asarray(P["mmask"]), jnp.asarray(P["target"][:n]),
        jnp.asarray(P["tmask"][:n]), jnp.asarray(P["T0"]),
        max_dist_match2=625.0, epsilon=1e-7, max_iterations=60,
    )
    jT = np.asarray(jr.T)
    np.testing.assert_allclose(r0["icp_quat_1"][:3, 3], jT[:3, 3], atol=0.5)
    np.testing.assert_allclose(r0["icp_quat_1"][:3, :3], jT[:3, :3], atol=1e-3)
    np.testing.assert_allclose(r0["icp_quat_1"], np.eye(4), atol=0.05)
    assert r0["icp_quat_1_it"][1] == float(jr.n_pairs)
    links = P["links"]
    pos, theta, *_ = jlum_run(
        jnp.asarray(P["locals"]), jnp.asarray(P["masks"]), jnp.asarray(links),
        jnp.asarray(np.ones(len(links), bool)), jnp.asarray(P["pos0"]), jnp.asarray(P["theta0"]),
        jnp.int32(len(P["locals"])), jnp.float32(625.0), jnp.float32(1e-4), iterations=5,
    )
    np.testing.assert_allclose(r0["pos"], np.asarray(pos), atol=1e-3)
    np.testing.assert_allclose(r0["theta"], np.asarray(theta), atol=1e-5)
