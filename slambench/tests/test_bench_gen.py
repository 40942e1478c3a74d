"""The generators make the same scans from the same seed, other scans
from another, with the shapes and statistics the configuration states."""

from __future__ import annotations

import numpy as np
import pytest
from conftest import tiny_cell

from slambench.gen import city, ring


def _make(name, seed, n_sets=1):
    cell = tiny_cell(name)
    gen = {"ring": ring, "city": city}[cell.cfg["generator"]]
    return cell.cfg["scene"], gen.generate(cell.cfg["scene"], n_sets, seed, "cpu")


@pytest.mark.parametrize("name", ["ring-graph", "city-seq"])
def test_same_seed_same_scans(name):
    scene, a = _make(name, 2**31 + 977)
    _, b = _make(name, 2**31 + 977)
    _, c = _make(name, 2**31 + 978)
    for x, y in zip(a[0]["locals"], b[0]["locals"]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.stack(a[0]["odo"]), np.stack(b[0]["odo"]))
    assert not np.array_equal(a[0]["locals"][0], c[0]["locals"][0])
    assert len(a[0]["locals"]) == scene["n_scans"]
    assert all(x.shape == (scene["points_per_scan"], 3) and x.dtype == np.float32 for x in a[0]["locals"])


def test_sets_differ_and_seeds_beyond_63_bits_wrap():
    _, sets = _make("ring-graph", 3, n_sets=2)
    assert not np.array_equal(sets[0]["locals"][0], sets[1]["locals"][0])
    _, big = _make("ring-graph", 3 + (1 << 63))
    np.testing.assert_array_equal(big[0]["locals"][5], sets[0]["locals"][5])


def test_ring_scans_sit_in_the_corridor():
    scene, sets = _make("ring-graph", 11)
    d = sets[0]
    spacing = np.linalg.norm(np.diff(np.stack([T[:3, 3] for T in d["true"]]), axis=0), axis=1)
    expect = 2 * scene["radius_cm"] * np.sin(scene["laps"] * np.pi / scene["n_scans"])  # the chord
    np.testing.assert_allclose(spacing, expect, rtol=1e-6)
    w = d["locals"][3].astype(np.float64) @ d["true"][3][:3, :3].T + d["true"][3][:3, 3]
    r = np.hypot(w[:, 0], w[:, 2])
    lo = scene["radius_cm"] - scene["half_width_cm"] - 5 * scene["noise_cm"]
    hi = scene["radius_cm"] + scene["half_width_cm"] + 5 * scene["noise_cm"]
    assert ((r > lo) & (r < hi)).all()
    assert np.abs(w[:, 1]).max() < scene["half_height_cm"] + 5 * scene["noise_cm"]
    drift = np.stack([o[:3, 3] - t[:3, 3] for o, t in zip(d["odo"], d["true"])])
    steps = np.diff(drift, axis=0)
    assert 0.5 * scene["drift_cm"] < steps.std() < 2 * scene["drift_cm"]
