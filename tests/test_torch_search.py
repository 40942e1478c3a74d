"""Range, box and segment searches of the port (``ops.search``) against
the JAX package's, on the same numpy inputs (those of
tests/test_search_bkd.py, masks added).

Bounds: equal counts and equal found sets; d² within 1e-3 cm² and
sorted; the truncation flag (count == K) where the JAX package raises
it; the box and segment masks and the segment's nearest point equal.
Along a direction, d² = |m − q|² − ((m − q)·dir)² cancels in f32 in both
packages, so there d² agrees within 1e-3 cm² + 2^-20·|m − q|² (a few
ulps of the cancelled terms; 0.01 cm² at 100 cm).
The port ranks candidates on direct differences, the JAX package on the
|q|²+|m|²−2q·m expansion: the found sets agree wherever count < K.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dtk.ops import search as jsearch
from tpu3dtk_torch.ops import search as tsearch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _sets(idx, found):
    return [set(r[f].tolist()) for r, f in zip(np.asarray(idx), np.asarray(found))]


def _assert_same(t, j, query, model):
    """Equal counts and found sets; d² within 1e-3 cm², plus 2^-20 of
    |m − q|² where ``query`` and ``model`` are given (the along-dir
    cancellation)."""
    tidx, td2, tfound, tcount = (x.numpy() for x in t)
    jidx, jd2, jfound, jcount = (np.asarray(x) for x in j)
    np.testing.assert_array_equal(tcount, jcount)
    assert tcount.dtype == np.int32 and tidx.shape == jidx.shape
    assert _sets(tidx, tfound) == _sets(jidx, jfound)
    tol = 1e-3
    if query is not None:
        tol = tol + 2.0**-20 * ((model[tidx] - query[:, None]) ** 2).sum(-1)
    assert (np.abs(np.where(tfound, td2 - jd2, 0)) <= tol).all()
    for row, c in zip(td2, tcount):
        assert (np.diff(row[:c]) >= 0).all()
    return tcount


@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_range_search_matches_jax(seed):
    rng = np.random.default_rng(seed)
    model = rng.uniform(0, 300, (800, 3)).astype(np.float32)
    query = rng.uniform(0, 300, (100, 3)).astype(np.float32)
    mm = rng.uniform(size=800) > 0.1
    qm = rng.uniform(size=100) > 0.05
    md2 = 40.0**2
    t = tsearch.fixed_range_search(_t(query), _t(qm), _t(model), _t(mm), md2, K=64)
    j = jsearch.fixed_range_search(jnp.asarray(query), jnp.asarray(qm), jnp.asarray(model),
                                   jnp.asarray(mm), jnp.float32(md2), K=64)
    count = _assert_same(t, j, None, None)
    assert (count < 64).all() and count.sum() > 100
    truth = ((query[:, None].astype(np.float64) - model[None]) ** 2).sum(-1) < md2
    np.testing.assert_array_equal(count, (truth & mm[None] & qm[:, None]).sum(1))


def test_fixed_range_truncation_flag_matches_jax():
    rng = np.random.default_rng(42)
    model = rng.uniform(0, 10, (500, 3)).astype(np.float32)
    query = model[:4] + 0.1
    t = tsearch.fixed_range_search(_t(query), torch.ones(4, dtype=torch.bool), _t(model),
                                   torch.ones(500, dtype=torch.bool), 100.0, K=8)
    j = jsearch.fixed_range_search(jnp.asarray(query), jnp.ones(4, bool), jnp.asarray(model),
                                   jnp.ones(500, bool), jnp.float32(100.0), K=8)
    assert (t[3].numpy() == 8).all() and (np.asarray(j[3]) == 8).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_range_along_dir_matches_jax(seed):
    rng = np.random.default_rng(seed)
    model = rng.uniform(0, 200, (600, 3)).astype(np.float32)
    query = rng.uniform(0, 200, (50, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    mm = rng.uniform(size=600) > 0.1
    md2 = 15.0**2
    t = tsearch.fixed_range_search_along_dir(
        _t(query), _t(dirs), torch.ones(50, dtype=torch.bool), _t(model), _t(mm), md2, K=128)
    j = jsearch.fixed_range_search_along_dir(
        jnp.asarray(query), jnp.asarray(dirs), jnp.ones(50, bool), jnp.asarray(model),
        jnp.asarray(mm), jnp.float32(md2), K=128)
    count = _assert_same(t, j, query, model)
    assert (count < 128).all() and count.sum() > 50


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_and_segment_searches_match_jax(seed):
    rng = np.random.default_rng(seed)
    model = rng.uniform(0, 100, (1000, 3)).astype(np.float32)
    mm = rng.uniform(size=1000) > 0.2
    lo = rng.uniform(0, 50, 3).astype(np.float32)
    hi = (lo + rng.uniform(10, 50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tsearch.aabb_search(_t(model), _t(mm), _t(lo), _t(hi)).numpy(),
        np.asarray(jsearch.aabb_search(jnp.asarray(model), jnp.asarray(mm), jnp.asarray(lo),
                                       jnp.asarray(hi))),
    )
    p1, p2 = (rng.uniform(0, 100, 3).astype(np.float32) for _ in range(2))
    args_t = (_t(p1), _t(p2), _t(model), _t(mm))
    args_j = (jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(model), jnp.asarray(mm))
    for md2 in (4.0, 400.0):
        ti, td2, tf = tsearch.segment_search_1nn(*args_t, md2)
        ji, jd2, jf = jsearch.segment_search_1nn(*args_j, jnp.float32(md2))
        assert int(ti) == int(ji) and bool(tf) == bool(jf)
        assert abs(float(td2) - float(jd2)) <= 1e-3
        tall = tsearch.segment_search_all(*args_t, md2).numpy()
        jall = np.asarray(jsearch.segment_search_all(*args_j, jnp.float32(md2)))
        np.testing.assert_array_equal(tall, jall)
    assert tall.sum() > 10
