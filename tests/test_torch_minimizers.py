"""The port's pair statistics and minimizers against the JAX package's
on the same pairs.  Both accumulate in f32 (sum_d2 in f64) in different
summation orders, so statistics agree to f32 rounding of sums over ~2k
pairs of cm-scale points (rtol 1e-5) and poses to 1e-4 (cm / rotation
entries).  Given the SAME statistics (the JAX package's, carried across
as numpy), each of the ten minimizers gives the JAX transform within
1e-5 of its largest entry (f32 closed forms in another op order);
lumeuler and lumquat are given a current pose."""

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


def test_unported_minimizer_names_its_roadmap_item(capsys, tmp_path):
    """Every slam6D id 1..10 is ported; an id outside them exits 2 (the
    JAX package's CLI falls back to quat for it), and an unknown name
    raises."""
    from tpu3dtk_torch.cli import slam6d as tcli

    assert sorted(tcli.ALGO_NAMES) == list(range(1, 11))
    assert set(tcli.ALGO_NAMES.values()) == set(tmz.MINIMIZERS) == set(jmz.MINIMIZERS)
    for algo in ("0", "11"):
        with pytest.raises(SystemExit) as e:
            tcli.main([str(tmp_path), "-a", algo])
        assert e.value.code == 2
        assert "1..10" in capsys.readouterr().err
    with pytest.raises(ValueError, match="unknown minimizer"):
        tmz.get_minimizer("newton")


def _same_stats(seed=4):
    """The JAX package's PairStats and NapxStats of one pair set, and the
    same numbers as the port's tuples."""
    m, d, w, _T = _pairs(seed)
    js = jmz.pair_stats(jnp.asarray(m), jnp.asarray(d), jnp.asarray(w))
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=d.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    jn = jmz.napx_stats(jnp.asarray(m), jnp.asarray(d), jnp.asarray(nrm), jnp.asarray(w))
    ts = tmz.PairStats(*(torch.as_tensor(np.array(v)) for v in js))
    tn = tmz.NapxStats(*(torch.as_tensor(np.array(v)) for v in jn))
    return (js, jn), (ts, tn), (m, d, nrm, w)


@pytest.mark.parametrize("name", sorted(jmz.MINIMIZERS))
def test_every_minimizer_matches_jax_on_the_same_stats(name):
    (js, jn), (ts, tn), _ = _same_stats()
    T_cur = np.asarray(jm3.euler_to_matrix4([120.0, -35.0, 60.0], [0.2, -0.4, 0.1], xp=np),
                       np.float32)
    if name == "napx":
        jT, jerr = jmz.align_napx(jn)
        tT, terr = tmz.align_napx(tn)
    elif name in ("lumeuler", "lumquat"):
        jT, jerr = jmz.MINIMIZERS[name](js, jnp.asarray(T_cur))
        tT, terr = tmz.MINIMIZERS[name](ts, torch.as_tensor(T_cur))
    else:
        jT, jerr = jmz.MINIMIZERS[name](js)
        tT, terr = tmz.MINIMIZERS[name](ts)
    jT = np.asarray(jT)
    assert tT.shape == (4, 4) and tT.dtype == torch.float32
    assert np.abs(jT[:3, 3]).max() > 1.0  # a real motion
    np.testing.assert_allclose(tT.numpy(), jT, rtol=0, atol=1e-5 * max(np.abs(jT).max(), 1.0))
    np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-6)


def test_napx_stats_match_jax():
    (_js, jn), _t, (m, d, nrm, w) = _same_stats(5)
    tn = tmz.napx_stats(*(torch.as_tensor(a) for a in (m, d, nrm, w)))
    for f in tmz.NapxStats._fields:
        got, want = getattr(tn, f).numpy(), np.asarray(getattr(jn, f))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1.0),
                                   err_msg=f)


def test_raw_moment_properties_match_jax():
    js, ts, _ = _stats_both(2)
    for f in ("sum_m", "sum_d", "Dm", "Dd", "Mm"):
        want = np.asarray(getattr(js, f))
        np.testing.assert_allclose(getattr(ts, f).numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=f)


def test_helix_takes_the_zero_rotation_limit_on_aligned_pairs():
    """On exactly aligned pairs (a lattice cloud matched to itself, as
    -O 0 voxel centres converge) the helix system's right-hand side is
    zero, so c = 0 and c·c̄ / |c|² is 0/0.  The port takes the zero
    rotation limit (R = I, t = c̄ = 0) of graphslam_variants'
    _helix_computeRt, with no host read; the JAX package's ICP
    align_helix returns a NaN translation there (ROADMAP queue 3)."""
    g = np.stack(np.meshgrid(*(np.arange(6.0) * 25.0,) * 3, indexing="ij"), -1)
    P = torch.as_tensor(g.reshape(-1, 3) - [60.0, 40.0, 75.0], dtype=torch.float32)
    w = torch.ones(len(P), dtype=torch.bool)
    T, err = tmz.align_helix(tmz.pair_stats(P, P, w))
    assert bool(torch.isfinite(T).all())
    np.testing.assert_array_equal(T.numpy(), np.eye(4, dtype=np.float32))
    assert float(err) == 0.0
    # a small motion still takes the general formula, as JAX does
    m, d, w2, _T = _pairs(6)
    js = jmz.pair_stats(jnp.asarray(m), jnp.asarray(d), jnp.asarray(w2))
    ts = tmz.PairStats(*(torch.as_tensor(np.array(v)) for v in js))
    jT, _ = jmz.align_helix(js)
    tT, _ = tmz.align_helix(ts)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0,
                               atol=1e-5 * max(np.abs(np.asarray(jT)).max(), 1.0))
