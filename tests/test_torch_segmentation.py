"""The port's segmentation (``models.segmentation``) against the JAX
package's, on the same numpy inputs made from a seed (the scenes of
tests/test_segmentation.py), on the CPU (``device="cpu"``).

Bounds:
- the FH merge (``_fh_merge``) on the JAX package's own k-NN edges:
  labels bit-identical to the JAX ``fh_segmentation``'s;
- ``fh_segmentation`` (the k-NN on the port's side too) on jittered
  clouds, where both rankings agree: labels equal up to relabeling;
- region growing and the graph cut: labels equal up to relabeling.
"""

import numpy as np
import pytest
import torch

from tpu3dtk.models import segmentation as jseg
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import segmentation as tseg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_partition(a, b):
    """Equal labels up to a one-to-one relabeling (-1 stays -1)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    pairs = set(zip(a.tolist(), b.tolist()))
    assert len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))
    assert all((x == -1) == (y == -1) for x, y in pairs)


def _two_clusters(rng):
    a = rng.normal(0, 5, (300, 3))
    b = rng.normal(0, 5, (300, 3)) + np.array([200.0, 0, 0])
    return np.concatenate([a, b]), dict(k=6, threshold=100.0, min_size=10)


def _outlier(rng):
    return np.concatenate([rng.normal(0, 5, (200, 3)), [[50.0, 0, 0]]]), dict(
        k=5, threshold=10.0, min_size=5)


def _uniform(rng):
    return rng.uniform(0, 500, (3000, 3)), dict(k=6, threshold=60.0, min_size=20)


SCENES = {"two_clusters": _two_clusters, "outlier": _outlier, "uniform": _uniform}


def _jax_edges(pts, k):
    """The de-duplicated edges the JAX ``fh_segmentation`` builds."""
    import jax.numpy as jnp

    from tpu3dtk.ops import knn as jknn

    pts = np.asarray(pts, np.float32)
    N = len(pts)
    ones = jnp.ones(N, bool)
    idx, d2 = jknn.knn_brute(jnp.asarray(pts), ones, jnp.asarray(pts), ones, min(k + 1, N))
    idx = np.asarray(idx)[:, 1:]
    w = np.sqrt(np.maximum(np.asarray(d2)[:, 1:], 0.0))
    src = np.repeat(np.arange(N), idx.shape[1])
    dst = idx.reshape(-1)
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    _, uniq = np.unique(lo.astype(np.int64) * N + hi, return_index=True)
    return lo[uniq], hi[uniq], w.reshape(-1)[uniq]


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_fh_merge_is_bit_identical_on_jax_edges(scene):
    pts, kw = SCENES[scene](np.random.default_rng(0))
    want = jseg.fh_segmentation(pts, jseg.FHParams(**kw))
    src, dst, w = _jax_edges(pts, kw["k"])
    got = tseg._fh_merge(src, dst, w, len(pts), interop.fh_params_from(kw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_fh_segmentation_matches_jax(scene, seed):
    pts, kw = SCENES[scene](np.random.default_rng(seed))
    want = jseg.fh_segmentation(pts, jseg.FHParams(**kw))
    got = tseg.fh_segmentation(pts, tseg.FHParams(**kw), device="cpu")
    assert_same_partition(got, want)


def _two_planes(rng, n=1200):
    a = np.stack([rng.uniform(0, 200, n), rng.uniform(0, 200, n), np.zeros(n)], 1)
    b = np.stack([rng.uniform(0, 200, n), np.zeros(n), rng.uniform(1.0, 200, n)], 1)
    normals = np.concatenate([np.tile([0.0, 0.0, 1.0], (n, 1)), np.tile([0.0, 1.0, 0.0], (n, 1))])
    return np.concatenate([a, b]), normals


@pytest.mark.parametrize("given_normals", [True, False])
def test_region_growing_matches_jax(given_normals):
    pts, normals = _two_planes(np.random.default_rng(0))
    pts = pts + np.random.default_rng(1).normal(0, 0.2, pts.shape)
    nrm = normals if given_normals else None
    want = jseg.region_growing_segmentation(pts, nrm, k=8, dist_thresh=30.0)
    got = tseg.region_growing_segmentation(pts, nrm, k=8, dist_thresh=30.0, device="cpu")
    assert_same_partition(got, want)
    assert (want >= 0).mean() > 0.9


def test_graph_cut_matches_jax():
    rng = np.random.default_rng(0)
    n = 4000
    a = np.stack([np.full(n, 300.0), rng.uniform(-200, 200, n), rng.uniform(-280, 280, n)], 1)
    b = np.stack([rng.uniform(-280, 280, n), rng.uniform(-200, 200, n), np.full(n, 300.0)], 1)
    pts = np.concatenate([a, b]) + rng.normal(0, 0.5, (2 * n, 3))
    kw = dict(width=180, height=90, min_points=30, tau=2.0)
    want = jseg.graph_cut_segmentation(pts, jseg.GraphCutParams(**kw))
    got = tseg.graph_cut_segmentation(pts, tseg.GraphCutParams(**kw))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got >= 0])) >= 2
