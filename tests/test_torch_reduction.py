"""The port's voxel reduction against the JAX package's.

Center and mean modes must give the same points in the same order, bit
for bit (same f32 operations, same stable voxel-id sort).  Random mode
draws its permutation from a torch.Generator instead of jax.random, so
it is held to the same number of points per voxel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu3dtk.ops import reduction as jred
from tpu3dtk_torch.ops import reduction as tred


def _cloud(seed, n=3000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-700, 900, (n, 3)).astype(np.float32)
    # dense clusters so that voxels hold several points
    pts[: n // 3] = rng.normal(100, 15, (n // 3, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    return pts, mask


def _jax(pts, mask, voxel, **kw):
    out, m = jred.voxel_reduce(jnp.asarray(pts), jnp.asarray(mask), voxel, **kw)
    return np.asarray(out), np.asarray(m)


def _port(pts, mask, voxel, **kw):
    out, m = tred.voxel_reduce(
        torch.as_tensor(pts), torch.as_tensor(mask), voxel, **kw
    )
    return out.numpy(), m.numpy()


@pytest.mark.parametrize("mode", ["center", "mean"])
@pytest.mark.parametrize("voxel", [10.0, 37.5])
def test_center_and_mean_equal_jax(mode, voxel):
    pts, mask = _cloud(5)
    jo, jm = _jax(pts, mask, voxel, mode=mode)
    to, tm = _port(pts, mask, voxel, mode=mode)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(to, jo)


def _voxel_counts(pts, voxel, origin):
    ij = np.floor((pts - origin) / np.float32(voxel)).astype(np.int64)
    keys, counts = np.unique(ij, axis=0, return_counts=True)
    return {tuple(k): c for k, c in zip(keys, counts)}


@pytest.mark.parametrize("nrpts", [1, 3])
@pytest.mark.parametrize("rm_scatter", [False, True])
def test_random_mode_same_counts_per_voxel(nrpts, rm_scatter):
    import jax

    pts, mask = _cloud(6)
    voxel = 25.0
    jo, jm = _jax(
        pts, mask, voxel, mode="random", nrpts=nrpts, rm_scatter=rm_scatter,
        key=jax.random.PRNGKey(0),
    )
    to, tm = _port(
        pts, mask, voxel, mode="random", nrpts=nrpts, rm_scatter=rm_scatter,
        generator=torch.Generator().manual_seed(0),
    )
    assert tm.sum() == jm.sum()
    origin = pts[mask].min(0)
    assert _voxel_counts(to[tm], voxel, origin) == _voxel_counts(jo[jm], voxel, origin)
    # every kept point is an input point
    inputs = {tuple(p) for p in pts[mask]}
    assert all(tuple(p) in inputs for p in to[tm])


@pytest.mark.parametrize("nrpts", [0, -1, 1])
def test_reduce_scan_matches_jax(nrpts):
    pts, _ = _cloud(7, n=2500)
    jr = jred.reduce_scan(pts, 20.0, nrpts, seed=0)
    tr = tred.reduce_scan(pts, 20.0, nrpts, seed=0, device="cpu")
    assert tr.shape == jr.shape
    if nrpts != 1:
        np.testing.assert_array_equal(tr, jr)
    # the random pick is reproducible from the seed
    np.testing.assert_array_equal(
        tr, tred.reduce_scan(pts, 20.0, nrpts, seed=0, device="cpu")
    )


@pytest.mark.parametrize("mode", ["center", "mean", "random"])
def test_all_masked_and_empty(mode):
    pts = torch.ones((5, 3))
    out, m = tred.voxel_reduce(
        pts, torch.zeros(5, dtype=torch.bool), 10.0, mode=mode,
        generator=torch.Generator().manual_seed(0),
    )
    assert out.shape == (5, 3) and not m.any()
    nrpts = {"center": 0, "mean": -1, "random": 1}[mode]
    assert tred.reduce_scan(np.zeros((0, 3)), 10.0, nrpts, device="cpu").shape == (0, 3)
