"""The port's dynamic-point removal (``models.peopleremover``) against the
JAX package's, on the same numpy inputs made from a seed (the scenes of
tests/test_peopleremover.py), on the CPU (``device="cpu"``).

Bounds: keep masks identical for the three ``maxrange_method``s, with f64
and f32 input points (the voxel ids are computed in the input's
precision in both packages); the port's ray tiles are a boolean OR, so a
tiny tile (a few rays) gives the same masks.
"""

import numpy as np
import pytest
import torch

from tpu3dtk.models import peopleremover as jpr
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import peopleremover as tpr
from tpu3dtk_torch.utils.metrics import metrics


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wall_blob(rng):
    """A wall seen at grazing incidence, a transient blob in scan 0."""
    wall = np.stack([rng.uniform(0, 400, 2500), rng.uniform(0, 300, 2500),
                     np.full(2500, 300.0)], axis=1)
    blob = rng.uniform(140, 170, (200, 3))
    blob[:, 2] = rng.uniform(100, 130, 200)
    scans = [np.concatenate([wall, blob]), wall + rng.normal(0, 0.5, wall.shape)]
    return scans, [np.array([200.0, 150.0, 0.0]), np.array([210.0, 150.0, 0.0])], 10.0


def _person(rng):
    w0 = rng.uniform(0, 400, (2000, 3))
    w0[:, 2] = 400.0
    w1 = rng.uniform(0, 400, (2000, 3))
    w1[:, 2] = 400.0
    person = np.array([200.0, 200.0, 200.0]) + rng.normal(0, 8, (300, 3))
    origin = np.array([200.0, 200.0, 0.0])
    return [np.concatenate([w0, person]), w1, w0[:500]], [origin, origin, origin + 30.0], 20.0


SCENES = {"wall_blob": _wall_blob, "person": _person}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", ["none", "normals", "1nearest"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_keep_masks_match_jax(scene, mode, dtype):
    scans, origins, vs = SCENES[scene](np.random.default_rng(0))
    scans = [s.astype(dtype) for s in scans]
    kw = dict(voxel_size=vs, maxrange_method=mode)
    want = jpr.remove_dynamic_points(scans, origins, jpr.PeopleRemoverParams(**kw))
    got = tpr.remove_dynamic_points(scans, origins, interop.people_remover_params_from(kw),
                                    device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[0][-200:].mean() < 0.2  # the transient is removed


@pytest.mark.parametrize("mode", ["none", "normals"])
def test_a_tiny_ray_tile_gives_the_same_masks(mode):
    scans, origins, vs = _wall_blob(np.random.default_rng(1))
    p = tpr.PeopleRemoverParams(voxel_size=vs, maxrange_method=mode, max_range=350.0)
    whole = tpr.remove_dynamic_points(scans, origins, p, device="cpu")
    metrics.reset()
    tiny = tpr.remove_dynamic_points(scans, origins, p, device="cpu", tile_samples=300)
    assert metrics.counters[tpr.RAY_TILES].total > 100
    for a, b in zip(whole, tiny):
        np.testing.assert_array_equal(a, b)
    want = jpr.remove_dynamic_points(
        scans, origins, jpr.PeopleRemoverParams(voxel_size=vs, maxrange_method=mode,
                                                max_range=350.0))
    for a, b in zip(tiny, want):
        np.testing.assert_array_equal(a, b)


def test_more_than_32_scans_refused():
    pts = [np.zeros((1, 3))] * 33
    with pytest.raises(ValueError, match="32"):
        tpr.remove_dynamic_points(pts, pts, device="cpu")
