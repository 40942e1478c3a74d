"""The port's linear octree (``ops.octree``) and spherical quadtree
(``ops.sphquad``), host numpy copies, against the JAX package's on the
same seeded inputs: tests/test_octree.py's four cases and the two
spherical-quadtree cases of tests/test_search_bkd.py, run through both
packages.

Bounds: equal trees (codes, counts, starts, points, origin, depth),
byte-equal serialized files, equal leaf representatives and LOD levels;
equal cone-search index sets and reduction picks."""

import numpy as np
import pytest

from tpu3dtk.ops import octree as joct
from tpu3dtk.ops import sphquad as jsq
from tpu3dtk_torch.ops import octree as toct
from tpu3dtk_torch.ops import sphquad as tsq


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_tree(a, b):
    assert (a.depth, a.size) == (b.depth, b.size)
    np.testing.assert_array_equal(a.origin, b.origin)
    for f in ("codes", "counts", "starts", "points_sorted"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# (the case of tests/test_octree.py, cloud, voxel size)
CASES = {
    "build_and_centers": (lambda r: r.uniform(0, 100, (5000, 3)), 10.0),
    "leaf_members_and_means": (lambda r: r.uniform(0, 64, (2000, 3)), 8.0),
    "lod_hierarchy": (lambda r: r.uniform(0, 100, (3000, 3)), 2.0),
    "serialize_roundtrip": (lambda r: r.uniform(-50, 50, (1000, 3)), 5.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_octree_matches_jax(case, tmp_path):
    make, voxel = CASES[case]
    pts = make(np.random.default_rng(42))
    j = joct.build_octree(pts, voxel_size=voxel)
    t = toct.build_octree(pts, voxel_size=voxel)
    _same_tree(j, t)
    np.testing.assert_array_equal(t.leaf_centers(), j.leaf_centers())
    np.testing.assert_array_equal(t.leaf_means(), j.leaf_means())
    np.testing.assert_array_equal(t.leaf_random(seed=1), j.leaf_random(seed=1))
    for level in range(1, t.depth + 1):
        np.testing.assert_array_equal(t.lod_centers(level), j.lod_centers(level))
    for with_points in (True, False):
        pj, pt = tmp_path / f"j{with_points}.toct", tmp_path / f"t{with_points}.toct"
        j.serialize(str(pj), with_points=with_points)
        t.serialize(str(pt), with_points=with_points)
        assert pt.read_bytes() == pj.read_bytes()
        _same_tree(toct.LinearOctree.deserialize(str(pt)),
                   joct.LinearOctree.deserialize(str(pj)))
    codes = np.arange(0, 1 << 30, 7919, dtype=np.uint64)
    np.testing.assert_array_equal(toct._compact3(codes), joct._compact3(codes))
    np.testing.assert_array_equal(toct._spread3(codes & 0x1FFFFF), joct._spread3(codes & 0x1FFFFF))


def _directions(rng, n):
    d = rng.normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_spherical_quadtree_search_matches_jax():
    rng = np.random.default_rng(42)
    d = _directions(rng, 5000)
    pts = d * rng.uniform(50, 200, (5000, 1))
    j = jsq.SphericalQuadtree(pts, levels=5)
    t = tsq.SphericalQuadtree(pts, levels=5)
    for name in ("codes", "order", "bucket_start", "bucket_center", "bucket_cos_r"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for p, r in (((1.0, 0.3, -0.2), 0.3), ((-0.5, 0.1, 0.9), 0.05), ((0.0, 0.0, -1.0), 1.2)):
        p = np.asarray(p) / np.linalg.norm(p)
        got = np.sort(t.search(p, r))
        np.testing.assert_array_equal(got, np.sort(j.search(p, r)))
        np.testing.assert_array_equal(got, np.sort(np.nonzero(d @ p >= np.cos(r))[0]))


def test_spherical_quadtree_reduce_matches_jax():
    rng = np.random.default_rng(42)
    d = _directions(rng, 8000)
    j = jsq.SphericalQuadtree(d, levels=6)
    t = tsq.SphericalQuadtree(d, levels=6)
    for theta, numpts in ((0.2, 1), (0.05, 3)):
        sel = t.reduce(theta=theta, numpts=numpts, seed=4)
        np.testing.assert_array_equal(sel, j.reduce(theta=theta, numpts=numpts, seed=4))
        assert 0 < len(sel) < len(d)
