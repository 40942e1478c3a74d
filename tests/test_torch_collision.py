"""The port's collision detection (``models.collision``) against the JAX
package's, on the same numpy inputs made from a seed (the scenes of
tests/test_collision.py and a random trajectory), on the CPU
(``device="cpu"``).

Bounds: per-pose hit counts and collision flags equal; the swept-path
masks and counts equal.  No input lies within 1e-2 cm² of r² (both
packages accept on the recomputed f32 d² < r²).
"""

import numpy as np
import pytest
import torch

from tpu3dtk.core import math3d
from tpu3dtk.models import collision as jcol
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import collision as tcol


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wall_scene(rng):
    env = np.stack([np.full(2000, 100.0), rng.uniform(-200, 200, 2000),
                    rng.uniform(-200, 200, 2000)], axis=1)
    model = rng.uniform(-5, 5, (200, 3))
    poses = np.stack([
        np.asarray(math3d.euler_to_matrix4([x, 0.0, 0.0], [0.0, 0.1 * x / 100, 0.0]))
        for x in np.linspace(0.0, 110.0, 23)
    ])
    return env, model, poses


def _random_scene(rng):
    env = rng.uniform(-500, 500, (600, 3))
    model = rng.uniform(-20, 20, (300, 3))
    poses = np.stack([
        np.asarray(math3d.euler_to_matrix4(rng.uniform(-400, 400, 3), rng.uniform(-3, 3, 3)))
        for _ in range(12)
    ])
    return env, model, poses


@pytest.mark.parametrize("scene", [_wall_scene, _random_scene])
def test_detect_collisions_matches_jax(scene):
    env, model, poses = scene(np.random.default_rng(0))
    kw = dict(radius=10.0)
    want = jcol.detect_collisions(env, model, poses, jcol.CollisionParams(**kw))
    got = tcol.detect_collisions(env, model, poses, interop.collision_params_from(kw),
                                 device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("radius", [10.0, 25.0])
def test_sweep_collisions_matches_jax(radius):
    rng = np.random.default_rng(1)
    env = rng.uniform(0, 100, (2000, 3))
    traj = np.array([[0, 50, 50], [100, 50, 50], [100, 0, 0], [20, 80, 30]], np.float64)
    want = jcol.sweep_collisions(env, traj, radius=radius)
    got = tcol.sweep_collisions(env, traj, radius=radius, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] > 0
