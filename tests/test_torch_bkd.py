"""The port's Bkd forest (``ops.bkd.BkdForest``) against the JAX
package's, on the CPU (``device="cpu"``): tests/test_search_bkd.py's
three bkd cases, run through both packages on the same seeded inputs.

Bounds: the same forest layout (blocks by level, alive counts);
``find_closest`` the same found flags and points, d² within 1e-2 cm² of
the JAX package's and of a cKDTree oracle (the packages rank in f32 in
other orders); ``fixed_range_search`` the same counts and the same found
point sets, d² within 1e-2 cm²; K1 is not launched on the CPU."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from tests.conftest import make_room_cloud
from tpu3dtk.ops.bkd import BkdForest as JForest
from tpu3dtk_torch.ops import nn_cuda
from tpu3dtk_torch.ops.bkd import BkdForest as TForest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(f):
    return sorted((lvl, b.n_alive(), len(b.pts_np)) for lvl, b in f._levels.items()), len(f._buffer)


def _assert_closest_equal(t, j, atol_d2=1e-2):
    (tp, td, tf), (jp, jd, jf) = t, j
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tp[tf], jp[jf], atol=1e-4)
    np.testing.assert_allclose(td[tf], jd[jf], atol=atol_d2)
    assert np.isinf(td[~tf]).all()


def test_bkd_insert_query_matches_jax():
    rng = np.random.default_rng(42)
    pts = make_room_cloud(rng, n=3000, size=500.0).astype(np.float32)
    jf, tf = JForest(buffer_size=256), TForest(buffer_size=256, device="cpu")
    for k in range(0, len(pts), 500):
        jf.insert(pts[k : k + 500])
        tf.insert(pts[k : k + 500])
    assert tf.size() == jf.size() == len(pts)
    assert _layout(tf) == _layout(jf)
    q = pts[rng.integers(0, len(pts), 64)] + rng.normal(0, 2, (64, 3)).astype(np.float32)
    launches = nn_cuda.nn_brute_kernel.launches
    t = tf.find_closest(q, np.ones(64, bool), 625.0)
    _assert_closest_equal(t, jf.find_closest(q, np.ones(64, bool), 625.0))
    dt, it = cKDTree(pts).query(q)
    assert t[2].all()
    np.testing.assert_allclose(t[1], dt**2, atol=1e-2)
    np.testing.assert_allclose(t[0], pts[it], atol=1e-4)
    assert nn_cuda.nn_brute_kernel.launches == launches  # CPU: the plain path
    np.testing.assert_array_equal(np.sort(tf.collect_pts(), axis=0), np.sort(jf.collect_pts(), axis=0))


def test_bkd_remove_matches_jax():
    rng = np.random.default_rng(42)
    pts = rng.uniform(0, 100, (600, 3)).astype(np.float32)
    jf, tf = JForest(pts, buffer_size=128), TForest(pts, buffer_size=128, device="cpu")
    tf.find_closest(pts[:5], np.ones(5, bool), 1e-4)  # prepares the blocks' models
    for victim in (pts[10], pts[599], pts[300]):
        n = tf.remove(victim)
        assert n == jf.remove(victim) >= 1
    assert tf.size() == jf.size() == len(pts) - 3
    assert _layout(tf) == _layout(jf)
    q = np.concatenate([pts[[10, 599, 300, 11]], rng.uniform(0, 100, (40, 3))]).astype(np.float32)
    t = tf.find_closest(q, np.ones(len(q), bool), 400.0)
    _assert_closest_equal(t, jf.find_closest(q, np.ones(len(q), bool), 400.0))
    # the removed points no longer match at zero distance
    assert (t[1][:3] > 1e-6).all()
    t = tf.find_closest(pts[10][None], np.ones(1, bool), 1e-4)
    assert not t[2][0]


@pytest.mark.parametrize("K", [16, 64])
def test_bkd_range_search_matches_jax(K):
    rng = np.random.default_rng(42)
    pts = rng.uniform(0, 200, (900, 3)).astype(np.float32)
    jf, tf = JForest(buffer_size=200), TForest(buffer_size=200, device="cpu")
    jf.insert(pts)
    tf.insert(pts)
    q = pts[:16]
    qmask = np.ones(16, bool)
    qmask[3] = False
    tp, td, tfound, tcnt = tf.fixed_range_search(q, qmask, 25.0**2, K=K)
    jp, jd, jfound, jcnt = jf.fixed_range_search(q, qmask, 25.0**2, K=K)
    assert tp.shape == (16, K, 3) and td.shape == (16, K)
    np.testing.assert_array_equal(tcnt, jcnt)
    d2 = ((q[:, None].astype(np.float64) - pts[None].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_array_equal(tcnt, (d2 < 625.0).sum(1) * qmask)
    for r in range(16):
        a = sorted(map(tuple, tp[r][tfound[r]].tolist()))
        b = sorted(map(tuple, jp[r][jfound[r]].tolist()))
        assert a == b
        np.testing.assert_allclose(np.sort(td[r][tfound[r]]), np.sort(jd[r][jfound[r]]), atol=1e-2)
        assert (np.diff(td[r][tfound[r]]) >= 0).all()
