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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run has six test processes, and
    eight spinning threads each slow every process on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _jax_k1(q, qm, m, mm, md2):
    return tuple(
        np.asarray(a) for a in nn_pallas.nn_brute_mxu(
            jnp.asarray(q), jnp.asarray(qm), jnp.asarray(m), jnp.asarray(mm),
            md2, precise=True,
        )
    )


@pytest.mark.parametrize("case", ["masked", "masked_tails", "all_masked"])
def test_prepared_model_equals_bare_call(case):
    """A model prepared once (``prepare_brute_model``) gives, through
    ``nn_brute`` and ``nn_brute_auto``, the bare call's answers bit for
    bit; both agree with the JAX Pallas K1 and the f64 oracle under the
    bounds stated at the top."""
    rng = np.random.default_rng({"masked": 11, "masked_tails": 12, "all_masked": 13}[case])
    Q, M = 700, 5000
    q, m = _clouds(rng, Q, M, 600.0)
    qm = rng.uniform(size=Q) > 0.05
    if case == "masked":
        mm = rng.uniform(size=M) > 0.15
    elif case == "masked_tails":  # clouds padded to a cap, as the ICP path pads them
        mm, qm = np.arange(M) < 4200, np.arange(Q) < 650
        m[4200:], q[650:] = 0.0, 0.0
    else:
        mm = np.zeros(M, bool)
    md2 = 625.0
    bm = tnn.prepare_brute_model(_t(m), _t(mm))
    assert bm.packed.shape == (M, 4) and bm.packed.dtype == torch.float32
    assert torch.isinf(bm.packed[~_t(mm), :3]).all() and not bm.packed[:, 3].any()
    assert torch.equal(bm.center, tnn.masked_center(_t(m), _t(mm)))
    assert torch.equal(bm.packed[_t(mm), :3], (_t(m) - bm.center)[_t(mm)])
    bare = tnn.nn_brute(_t(q), _t(qm), _t(m), _t(mm), md2)
    for out in (
        tnn.nn_brute(_t(q), _t(qm), bm, None, md2),
        tnn.nn_brute_auto(_t(q), _t(qm), bm, None, md2),
        tnn.nn_brute_auto(_t(q), _t(qm), _t(m), _t(mm), md2),
    ):
        for x, y in zip(out, bare):
            assert x.dtype == y.dtype and torch.equal(x, y)
    idx, d2, found = (a.numpy() for a in bare)
    jidx, jd2, jfound = _jax_k1(q, qm, m, mm, md2)
    np.testing.assert_array_equal(found, jfound)
    if case == "all_masked":
        assert not found.any() and (idx == 0).all() and (d2 == np.float32(tnn.BIG)).all()
        return
    assert mm[idx[found]].all()
    assert (idx[found] == jidx[found]).mean() > 0.999
    np.testing.assert_allclose(d2[found], jd2[found], atol=1e-2)
    midx = np.flatnonzero(mm)
    d, k = cKDTree(m[midx].astype(np.float64)).query(q.astype(np.float64))
    assert (idx[qm] == midx[k][qm]).mean() > 0.999
    np.testing.assert_allclose(d2[qm], (d**2)[qm], atol=1e-2)
    np.testing.assert_array_equal(found, qm & (d2 < np.float32(md2)))


def test_prepared_model_argument_errors():
    m = torch.zeros((5, 3))
    ok = torch.ones(5, dtype=torch.bool)
    bm = tnn.prepare_brute_model(m, ok)
    with pytest.raises(ValueError, match="own mask"):
        tnn.nn_brute(m, ok, bm, ok, 1.0)
    with pytest.raises(ValueError, match="needs its mask"):
        tnn.nn_brute(m, ok, m, None, 1.0)
    with pytest.raises(ValueError):
        tnn.prepare_brute_model(torch.zeros((5, 4)), ok)
    with pytest.raises(ValueError):
        tnn.prepare_brute_model(m, ok[:4])
    with pytest.raises(TypeError):
        tnn.prepare_brute_model(m.double(), ok)
    with pytest.raises(TypeError):
        tnn.prepare_brute_model(m, ok.to(torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):  # the kernel wrapper: no fallback
        nn_cuda.nn_brute_kernel(m, ok, bm, None, 1.0)


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
