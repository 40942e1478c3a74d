"""The port's pair statistics and minimizers against the JAX package's
on the same pairs.  Both accumulate in f32 (sum_d2 in f64) in different
summation orders, so statistics agree to f32 rounding of sums over ~2k
pairs of cm-scale points (rtol 1e-5) and poses to 1e-4 (cm / rotation
entries)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu3dtk.core import math3d as jm3
from tpu3dtk.models import minimizers as jmz
from tpu3dtk_torch.models import minimizers as tmz


def _pairs(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-300, 300, (n, 3))
    T = np.asarray(jm3.euler_to_matrix4([12.0, -5.0, 7.0], [0.03, -0.05, 0.02], xp=np))
    m = d @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.5, (n, 3))
    w = rng.uniform(size=n) > 0.2
    return m.astype(np.float32), d.astype(np.float32), w, T


def _stats_both(seed=0):
    m, d, w, T = _pairs(seed)
    js = jmz.pair_stats(jnp.asarray(m), jnp.asarray(d), jnp.asarray(w))
    ts = tmz.pair_stats(torch.as_tensor(m), torch.as_tensor(d), torch.as_tensor(w))
    return js, ts, T


def test_pair_stats_matches_jax():
    js, ts, _ = _stats_both()
    assert ts.sum_d2.dtype == torch.float64
    for f in tmz.PairStats._fields:
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale, err_msg=f)


@pytest.mark.parametrize("name", ["quat", "svd"])
def test_minimizer_matches_jax(name):
    js, ts, T_true = _stats_both(1)
    jT, jerr = jmz.MINIMIZERS[name](js)
    tT, terr = tmz.MINIMIZERS[name](ts)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-6)
    # and both recover the generating transform
    np.testing.assert_allclose(tT.numpy(), T_true, atol=5e-2)


def test_quat_power_iteration_matches_eigh():
    """_max_eigvec4 is the JAX package's power iteration: it finds the
    dominant eigenvector that eigh finds, up to sign."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(4, 4)).astype(np.float32)
    Q = A + A.T
    v = tmz._max_eigvec4(torch.as_tensor(Q)).numpy()
    w, V = np.linalg.eigh(Q.astype(np.float64))
    ref = V[:, np.argmax(w)]
    assert abs(abs(float(v @ ref)) - 1.0) < 1e-4
    jv = np.asarray(jmz._max_eigvec4(jnp.asarray(Q)))
    np.testing.assert_allclose(v, jv, atol=1e-5)


def test_unported_minimizer_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="A11"):
        tmz.get_minimizer("napx")
