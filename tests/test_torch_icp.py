"""The port's ICP loop against the JAX package's on the same clouds.

Bounds (tests/test_graph_pipeline_device.py:103-109): poses within
0.5 cm translation and 1e-3 on rotation entries; iteration counts within
±1, since f32 sums in another order can move a stop test by one
iteration."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import make_room_cloud
from tpu3dtk.core import math3d as jm3
from tpu3dtk.models import icp as jicp
from tpu3dtk_torch.models import icp as ticp


def _pad(pts, cap):
    out = np.zeros((cap, 3), np.float32)
    out[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    return out, mask


def _both(model, mmask, target, tmask, T0, **kw):
    jr = jicp.icp_pair(
        jnp.asarray(model), jnp.asarray(mmask), jnp.asarray(target),
        jnp.asarray(tmask), jnp.asarray(T0), **kw,
    )
    tr = ticp.icp_pair(
        torch.as_tensor(model), torch.as_tensor(mmask), torch.as_tensor(target),
        torch.as_tensor(tmask), torch.as_tensor(T0), **kw,
    )
    return jr, tr


def _assert_close(jr, tr):
    jT, tT = np.asarray(jr.T), tr.T.numpy()
    np.testing.assert_allclose(tT[:3, 3], jT[:3, 3], atol=0.5)
    np.testing.assert_allclose(tT[:3, :3], jT[:3, :3], atol=1e-3)
    assert abs(tr.iterations - int(jr.iterations)) <= 1


@pytest.mark.parametrize("minimizer", ["quat", "svd"])
def test_icp_pair_matches_jax(minimizer):
    rng = np.random.default_rng(42)
    cloud = make_room_cloud(rng, n=3000)
    noisy = cloud + rng.normal(0, 0.5, cloud.shape)
    T_pert = np.asarray(
        jm3.euler_to_matrix4([8.0, -5.0, 6.0], [0.02, -0.03, 0.015], xp=np),
        np.float32,
    )
    model, mmask = _pad(cloud, 3072)
    target, tmask = _pad(noisy, 3072)
    jr, tr = _both(
        model, mmask, target, tmask, T_pert,
        max_dist_match2=625.0, epsilon=1e-6, max_iterations=50,
        minimizer=minimizer,
    )
    _assert_close(jr, tr)
    np.testing.assert_allclose(tr.T.numpy(), np.eye(4), atol=0.1)
    assert abs(tr.error - float(jr.error)) < 1e-3
    assert tr.n_pairs == pytest.approx(float(jr.n_pairs), abs=5)
    assert isinstance(tr.error, float)


def test_icp_pair_prepares_the_model_once(monkeypatch):
    """The model is centred and packed once per match, every iteration
    ranks against that prepared model, and the result is the one a model
    prepared anew in every iteration gives."""
    from tpu3dtk_torch.ops import nn as tnn

    rng = np.random.default_rng(7)
    cloud = make_room_cloud(rng, n=2000)
    model, mmask = _pad(cloud, 2048)
    target, tmask = _pad(cloud + rng.normal(0, 0.5, cloud.shape), 2048)
    T0 = np.asarray(
        jm3.euler_to_matrix4([5.0, -3.0, 4.0], [0.01, -0.02, 0.01], xp=np), np.float32
    )
    args = [torch.as_tensor(a) for a in (model, mmask, target, tmask, T0)]
    kw = dict(max_dist_match2=625.0, epsilon=1e-6, max_iterations=50)
    calls = {"prepare": 0, "nn": 0}
    prepare, auto = tnn.prepare_brute_model, tnn.nn_brute_auto

    def counting_prepare(*a):
        calls["prepare"] += 1
        return prepare(*a)

    def counting_auto(query, qmask, model, mmask, max_dist2):
        calls["nn"] += 1
        assert isinstance(model, tnn.BruteModel) and mmask is None
        return auto(query, qmask, model, mmask, max_dist2)

    monkeypatch.setattr(tnn, "prepare_brute_model", counting_prepare)
    monkeypatch.setattr(tnn, "nn_brute_auto", counting_auto)
    tr = ticp.icp_pair(*args, **kw)
    assert calls["prepare"] == 1 and calls["nn"] == tr.iterations > 3

    def bare_pairs(bm, tgt_global, tmask, max_dist2):
        idx, _d2, found = auto(tgt_global, tmask, bm.model, bm.mmask, max_dist2)
        return bm.model[idx], found

    monkeypatch.setattr(ticp, "_find_pairs", bare_pairs)
    tr2 = ticp.icp_pair(*args, **kw)
    assert torch.equal(tr.T, tr2.T) and tr.iterations == tr2.iterations
    assert tr.error == tr2.error and tr.n_pairs == tr2.n_pairs
    np.testing.assert_allclose(tr.T.numpy(), np.eye(4), atol=0.1)


def test_icp_no_pairs_is_identity():
    rng = np.random.default_rng(1)
    cloud = make_room_cloud(rng, n=500)
    model, mmask = _pad(cloud, 512)
    target, tmask = _pad(cloud + 10000.0, 512)
    jr, tr = _both(
        model, mmask, target, tmask, np.eye(4, dtype=np.float32),
        max_dist_match2=100.0, epsilon=1e-6, max_iterations=10,
    )
    np.testing.assert_array_equal(tr.T.numpy(), np.eye(4))
    assert tr.iterations == int(jr.iterations) == 1
    assert tr.n_pairs == 0


def test_icp_subsample_converges():
    """-R: a fresh random subset per iteration (torch.Generator)."""
    rng = np.random.default_rng(2)
    cloud = make_room_cloud(rng, n=3000)
    model, mmask = _pad(cloud, 3072)
    T_pert = np.asarray(
        jm3.euler_to_matrix4([4.0, 3.0, -2.0], [0.01, 0.0, -0.01], xp=np),
        np.float32,
    )
    tr = ticp.icp_pair(
        torch.as_tensor(model), torch.as_tensor(mmask), torch.as_tensor(model),
        torch.as_tensor(mmask), torch.as_tensor(T_pert),
        max_dist_match2=625.0, epsilon=1e-6, max_iterations=60, subsample=2,
    )
    np.testing.assert_allclose(tr.T.numpy(), np.eye(4), atol=0.1)
    assert tr.n_pairs < 0.7 * mmask.sum()


def test_window_and_sequence_helpers_match_jax():
    """Model-window build and the two pose helpers of the device loop."""
    rng = np.random.default_rng(3)
    S, N = 4, 64
    locs = rng.normal(0, 100, (S, N, 3)).astype(np.float32)
    masks = rng.uniform(size=(S, N)) > 0.2
    mats = np.stack([
        jm3.euler_to_matrix4(rng.normal(0, 50, 3), rng.normal(0, 0.2, 3), xp=np)
        for _ in range(S)
    ]).astype(np.float32)
    for lo, hi, cap in [(1, 2, 1), (0, 3, 4), (2, 4, 2)]:
        jmodel, jmmask, *_ = jicp._seq_build(
            jnp.asarray(locs), jnp.asarray(masks), jnp.zeros((1, 1, 3)),
            jnp.asarray(mats), jnp.int32(lo), jnp.int32(hi), jnp.int32(hi),
            jnp.float32(625.0), has_normals=False, n_buckets=0, window_cap=cap,
        )
        tmodel, tmmask = ticp._window(
            torch.as_tensor(locs), torch.as_tensor(masks), torch.as_tensor(mats),
            lo, hi, cap,
        )
        np.testing.assert_array_equal(tmmask.numpy(), np.asarray(jmmask))
        np.testing.assert_allclose(tmodel.numpy(), np.asarray(jmodel), atol=1e-4)
    T = torch.as_tensor(mats[1])
    np.testing.assert_allclose(
        ticp._rigid_inv_f32(T).numpy(),
        np.asarray(jicp._rigid_inv_f32(jnp.asarray(mats[1]))), atol=1e-5,
    )
    np.testing.assert_allclose(
        ticp._orthonormalize_rot(T * 1.0001).numpy(),
        np.asarray(jicp._orthonormalize_rot(jnp.asarray(mats[1] * 1.0001))),
        atol=1e-5,
    )
