"""The port's plain K1 (``tpu3dtk_torch.ops.nn.nn_brute``) against the
JAX package's Pallas K1 (``nn_brute_mxu(precise=True)``, interpret mode
on the CPU) and against an f64 cKDTree oracle.

Tolerances: both sides rank in exact f32, so only near-ties may pick
different indices (agreement > 0.999, the pattern of
tests/test_tpu_accuracy.py); the chosen d² may differ from the true
minimum by f32 rounding of cm-scale coordinates (< 1e-2 cm²).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.spatial import cKDTree

from tpu3dtk.ops import nn as jnn
from tpu3dtk.ops import nn_pallas
from tpu3dtk_torch.ops import nn as tnn
from tpu3dtk_torch.ops import nn_cuda


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _port(q, qm, m, mm, md2):
    idx, d2, found = tnn.nn_brute_auto(_t(q), _t(qm), _t(m), _t(mm), md2)
    return idx.numpy(), d2.numpy(), found.numpy()


def _clouds(rng, Q, M, extent, noise=5.0):
    m = rng.uniform(-extent, extent, (M, 3)).astype(np.float32)
    q = (m[rng.integers(0, M, Q)] + rng.normal(0, noise, (Q, 3))).astype(np.float32)
    return q, m


def test_plain_k1_matches_jax_pallas_k1():
    """Masked model, Q and M off the TPU tile sizes (256 / 4096)."""
    rng = np.random.default_rng(1)
    Q, M = 300, 4500
    q, m = _clouds(rng, Q, M, 500.0)
    qm = rng.uniform(size=Q) > 0.05
    mm = rng.uniform(size=M) > 0.1
    md2 = 625.0
    idx, d2, found = _port(q, qm, m, mm, md2)
    jidx, jd2, jfound = (
        np.asarray(a) for a in nn_pallas.nn_brute_mxu(
            jnp.asarray(q), jnp.asarray(qm), jnp.asarray(m), jnp.asarray(mm),
            md2, precise=True,
        )
    )
    assert mm[idx[found]].all()
    np.testing.assert_array_equal(found, jfound)
    assert (idx[found] == jidx[found]).mean() > 0.999
    np.testing.assert_allclose(d2[found], jd2[found], atol=1e-2)


def test_plain_k1_matches_kdtree_oracle():
    rng = np.random.default_rng(2)
    q, m = _clouds(rng, 2000, 3000, 800.0)
    one_q, one_m = np.ones(len(q), bool), np.ones(len(m), bool)
    idx, d2, found = _port(q, one_q, m, one_m, 625.0)
    d, oidx = cKDTree(m.astype(np.float64)).query(q.astype(np.float64))
    od2 = d**2
    assert (idx == oidx).mean() > 0.999
    np.testing.assert_allclose(d2, od2, atol=1e-2)
    # found is the strict gate on the exact f32 d2
    np.testing.assert_array_equal(found, d2 < np.float32(625.0))
    assert (found == (od2 < 625.0)).mean() > 0.999


@pytest.mark.parametrize("engine", ["port", "jax_pallas"])
@pytest.mark.parametrize(
    "max_dist2,expect", [(100.0, False), (100.01, True), (99.99, False)]
)
def test_strict_boundary(engine, max_dist2, expect):
    """d² == max_dist2 is excluded, just above it is found
    (tests/test_nn_pallas.py:53-60)."""
    m = np.asarray([[10.0, 0.0, 0.0], [50.0, 0.0, 0.0]], np.float32)
    q = np.asarray([[0.0, 0.0, 0.0]], np.float32)
    qm, mm = np.ones(1, bool), np.ones(2, bool)
    if engine == "port":
        idx, d2, found = _port(q, qm, m, mm, max_dist2)
    else:
        idx, d2, found = (
            np.asarray(a) for a in nn_pallas.nn_brute_mxu(
                jnp.asarray(q), jnp.asarray(qm), jnp.asarray(m),
                jnp.asarray(mm), max_dist2, precise=True,
            )
        )
    assert int(idx[0]) == 0 and float(d2[0]) == 100.0
    assert bool(found[0]) is expect


def test_ties_keep_lowest_index_and_all_masked():
    m = np.asarray([[5.0, 0, 0], [-5.0, 0, 0], [5.0, 0, 0]], np.float32)
    q = np.zeros((2, 3), np.float32)
    idx, d2, found = _port(q, np.ones(2, bool), m, np.ones(3, bool), 100.0)
    assert idx.tolist() == [0, 0] and found.all()
    idx, d2, found = _port(
        q, np.ones(2, bool), m, np.asarray([False, True, True]), 100.0
    )
    assert idx.tolist() == [1, 1]
    idx, d2, found = _port(q, np.ones(2, bool), m, np.zeros(3, bool), 100.0)
    assert idx.tolist() == [0, 0] and not found.any()
    assert (d2 == np.float32(tnn.BIG)).all()


def test_launch_counter_stays_zero_on_cpu():
    rng = np.random.default_rng(3)
    q, m = _clouds(rng, 64, 128, 100.0)
    before = nn_cuda.nn_brute_kernel.launches
    _port(q, np.ones(64, bool), m, np.ones(128, bool), 625.0)
    assert nn_cuda.nn_brute_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is an error."""
    q = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        nn_cuda.nn_brute_kernel(
            q, torch.ones(4, dtype=torch.bool), q, torch.ones(4, dtype=torch.bool),
            1.0,
        )


def test_nn_brute_line_matches_jax():
    rng = np.random.default_rng(4)
    q, m = _clouds(rng, 400, 1500, 300.0)
    dirs = rng.normal(size=(400, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    qm = np.ones(400, bool)
    mm = rng.uniform(size=1500) > 0.1
    idx, d2, found = (
        a.numpy() for a in tnn.nn_brute_line(
            _t(q), _t(dirs), _t(qm), _t(m), _t(mm), 100.0
        )
    )
    jidx, jd2, jfound = (
        np.asarray(a) for a in jnn.nn_brute_line(
            jnp.asarray(q), jnp.asarray(dirs), jnp.asarray(qm), jnp.asarray(m),
            jnp.asarray(mm), jnp.float32(100.0),
        )
    )
    assert (idx == jidx).mean() > 0.999
    both = found & jfound & (idx == jidx)
    # the line distance |p−x|² − proj² cancels: both sides round it in
    # f32 through about eight operations, in different summation
    # orders, so they agree to ~16 ulp of |p−x|², not of the result
    full = ((m[idx] - q).astype(np.float64) ** 2).sum(1)
    assert (np.abs(d2 - jd2)[both] <= 16 * 2.0**-24 * full[both] + 1e-4).all()
    assert (found == jfound).mean() > 0.99
