"""The port's pose-graph solvers (``tpu3dtk_torch.models.pgsolve``)
against the JAX package's and the dense f64 solve, on the same random
LUM-shaped systems (tests/test_pgsolve.py's generator).

Bounds (all f64): ``link_rhs`` equal to the JAX ``assemble_GB``'s
right-hand side to 1e-12; ``solve_block_cg`` (run here on CPU tensors)
within 1e-8 of the largest entry of the dense solution and of the JAX
``solve_block_cg``; the host LUM path through its block-CG branch gives
the dense branch's poses within 5e-5 cm (the JAX package's own bound:
the f32 covariances of the next iteration pick up the solvers' last
digits) and 1e-7 on rotation entries."""

import numpy as np
import pytest
import torch

from tests.conftest import make_room_cloud
from tpu3dtk.core import math3d as jmath
from tpu3dtk.models import graphslam as jgs
from tpu3dtk.models import pgsolve as jpg
from tpu3dtk_torch.core.scan import Scan
from tpu3dtk_torch.models import graphslam as tgs
from tpu3dtk_torch.models import pgsolve as tpg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The clouds here are small: one intra-op thread is faster than
    eight, and does not fight the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_system(rng, n_scans=40, extra_links=25):
    """tests/test_pgsolve.py::_random_system: chain + random loop links,
    C = J Jᵀ + 0.5 I."""
    links = [(i, i + 1) for i in range(n_scans - 1)]
    for _ in range(extra_links):
        a, b = sorted(rng.choice(n_scans, 2, replace=False))
        links.append((int(a), int(b)))
    links = np.asarray(links, np.int32)
    J = rng.normal(size=(len(links), 6, 8))
    C = J @ J.transpose(0, 2, 1) + 0.5 * np.eye(6)[None]
    CD = rng.normal(size=(len(links), 6))
    return links, C, CD


def _dense(links, C, CD):
    n_scans = int(links.max()) + 1
    G, B = jgs.assemble_GB(links, C, CD, n_scans)
    return np.linalg.solve(G, B).reshape(n_scans - 1, 6), B.reshape(n_scans - 1, 6)


def test_link_rhs_matches_jax(rng):
    links, _C, CD = _random_system(rng)
    _x, B = _dense(links, _C, CD)
    got = tpg.link_rhs(links, torch.as_tensor(CD), int(links.max()))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), B, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_scans,extra", [(30, 15), (80, 60), (200, 150)])
def test_cg_solvers_match_dense_and_jax(rng, n_scans, extra):
    links, C, CD = _random_system(rng, n_scans, extra)
    x_dense, B = _dense(links, C, CD)
    n = n_scans - 1
    tol = 1e-8 * max(1.0, np.abs(x_dense).max())
    x_jax = jpg.solve_block_cg(links, C, B, n)
    x, iters = tpg.solve_block_cg(links, torch.as_tensor(C), torch.as_tensor(B), n)
    assert x.dtype == torch.float64 and 0 < iters <= max(200, 12 * n)
    assert np.abs(x.numpy() - x_dense).max() < tol
    assert np.abs(x.numpy() - x_jax).max() < tol


def test_device_cg_isolated_scans_stay_put(rng):
    """Scans no link reaches (the device path's pad slots): zero
    correction, no NaN from the regularized empty diagonal blocks."""
    links, C, CD = _random_system(rng, 12, 4)
    x_dense, B = _dense(links, C, CD)
    n = 16  # 5 variables beyond every link
    Bp = np.zeros((n, 6))
    Bp[: len(B)] = B
    x_dev, _ = tpg.solve_block_cg(links, torch.as_tensor(C), torch.as_tensor(Bp), n)
    x_dev = x_dev.numpy()
    assert np.isfinite(x_dev).all() and not x_dev[len(B):].any()
    assert np.abs(x_dev[: len(B)] - x_dense).max() < 1e-8 * np.abs(x_dense).max()


def test_host_lum_cg_branch_matches_dense(rng):
    """tests/test_pgsolve.py::test_do_graph_slam_cg_path_matches_dense
    for the port's host LUM loop: the dense and the block-CG branch."""
    cloud = make_room_cloud(rng, n=900, size=800.0)
    locals_, poses = [], []
    for i in range(5):
        T = np.asarray(jmath.euler_to_matrix4(
            np.array([i * 8.0, 0, 0]) + rng.normal(0, 2.0, 3), rng.normal(0, 0.01, 3)))
        Ti = np.linalg.inv(T)
        locals_.append(((Ti[:3, :3] @ cloud.T).T + Ti[:3, 3]).astype(np.float32))
        poses.append(T)

    def run(dense_max):
        scans = []
        for k, loc in enumerate(locals_):
            s = Scan.from_points(loc, f"{k:03d}")
            s.device = "cpu"
            s._reduced_local = loc.astype(np.float64)
            scans.append(s)
        links = tgs.build_proximity_graph(np.stack([s.rPos for s in scans]), 1e9, 2)
        tgs._do_graph_slam_host(scans, links, tgs.LumParams(
            max_dist_match2=2500.0, iterations=3, epsilon=1e-9,
            dense_solver_max_scans=dense_max, device="cpu"))
        return np.stack([s.transMat for s in scans])

    dense, cg = run(100), run(1)
    np.testing.assert_allclose(cg[:, :3, 3], dense[:, :3, 3], atol=5e-5)
    np.testing.assert_allclose(cg[:, :3, :3], dense[:, :3, :3], atol=1e-7)
    assert np.abs(dense[:, :3, 3]).max() > 1.0  # the relaxation moved the scans
