"""The port's GPS projection (``models.gps``) and curve fusion
(``models.curvefusion``) against the JAX package's, on the same numpy
inputs, on the CPU (``device="cpu"``).

Bounds: ``latlon_to_utm`` / ``scan_to_utm`` bit-identical (the same numpy
f64 code); ``associate_by_time`` identical; each per-window alignment
moves its window's points within 1e-4 cm of where the JAX package's
moves them, and its f64 error is within 1e-9.  The alignments' matrix
entries are not compared: a window of a curve is nearly collinear, the
rotation about its own line is undetermined, and the f32 power iteration
of the quaternion Horn solve settles there by rounding (the port's own
unbatched solve differs from the JAX package's by 5.7e-6 in the entries
on the drift case).  Fused positions within 1e-3 cm (the f64 blend,
summed in another order).
"""

import numpy as np
import pytest
import torch

from tpu3dtk.models import curvefusion as jcf
from tpu3dtk.models import gps as jgps
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import curvefusion as tcf
from tpu3dtk_torch.models import gps as tgps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_gps.py's anchors, and a grid around the globe
ANCHORS = [(0.0, 3.0), (45.0, 3.0), (49.7913, 9.9534), (-33.8688, 151.2093)]


@pytest.mark.parametrize("lat,lon", ANCHORS)
def test_latlon_to_utm_bit_identical(lat, lon):
    for a, b in zip(jgps.latlon_to_utm(lat, lon), tgps.latlon_to_utm(lat, lon)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_latlon_to_utm_arrays_and_scan_to_utm_bit_identical():
    rng = np.random.default_rng(3)
    lat, lon = rng.uniform(-80, 84, 500), rng.uniform(-180, 180, 500)
    for a, b in zip(jgps.latlon_to_utm(lat, lon), tgps.latlon_to_utm(lat, lon)):
        assert np.array_equal(a, b)
    pts = rng.uniform(-5e4, 5e4, (1000, 3))
    for lat0, lon0 in ANCHORS:
        assert np.array_equal(jgps.scan_to_utm(pts, lat0, lon0, 170.0),
                              tgps.scan_to_utm(pts, lat0, lon0, 170.0))


def test_associate_by_time_identical():
    rng = np.random.default_rng(5)
    ta = np.sort(rng.uniform(0, 100, 3000))
    tb = np.sort(rng.uniform(-5, 105, 300))
    assert np.array_equal(jcf.associate_by_time(ta, tb), tcf.associate_by_time(ta, tb))
    ta = np.array([0.0, 1.0, 2.5, 7.0])
    tb = np.array([0.2, 2.0, 3.0, 6.0])
    assert np.array_equal(tcf.associate_by_time(ta, tb), [0, 0, 1, 3])


def _drift_case(seed=42, n=200):
    """tests/test_aux_modules.py's drift case (the ``rng`` fixture's seed)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 10, n)
    truth = np.stack([100 * np.cos(t * 0.5), 0 * t, 100 * np.sin(t * 0.5)], axis=1)
    drift = np.cumsum(rng.normal(0, 0.5, (n, 3)), axis=0)
    odo = truth + drift
    gps = truth + rng.normal(0, 1.0, (n, 3))
    return t, truth, odo, gps


def _rigid_case(seed=9, n=240):
    """A curve and a copy moved rigidly, each window's pairs 1 mm apart."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 12, n)
    truth = np.stack([300 * np.cos(t * 0.4), 40 * np.sin(t), 250 * np.sin(t * 0.4)], axis=1)
    c, s = np.cos(0.05), np.sin(0.05)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    moved = truth @ R.T + np.array([12.0, -3.0, 7.0]) + rng.normal(0, 0.1, (n, 3))
    return t, truth, moved, truth


@pytest.mark.parametrize("case,window,stride", [
    ("rigid", 16, 8), ("drift", 16, 8), ("drift", 8, 4),
])
def test_segment_aligns_match(case, window, stride):
    t, _truth, odo, gps = _rigid_case() if case == "rigid" else _drift_case()
    pb = gps[jcf.associate_by_time(t, t)]
    starts_j, al_j, err_j = jcf._segment_aligns(odo, pb, window, stride)
    starts_p, al_p, err_p = tcf._segment_aligns(
        torch.as_tensor(odo), torch.as_tensor(pb), window, stride, torch.device("cpu"))
    al_p = al_p.numpy()
    assert np.array_equal(starts_j, starts_p)
    idx = np.minimum(starts_j[:, None] + np.arange(window)[None, :], len(odo) - 1)
    win = odo[idx]

    def moved(al):
        return np.einsum("sij,swj->swi", al[:, :3, :3], win) + al[:, None, :3, 3]

    np.testing.assert_allclose(moved(al_p), moved(al_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(err_p.numpy(), err_j, atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("window,stride,blend", [(16, 8, 0.3), (8, 4, 0.5), (7, 3, 0.0)])
def test_fused_positions_match(window, stride, blend):
    t, truth, odo, gps = _drift_case()
    fields = {"window": window, "stride": stride, "blend": blend}
    fj, ij = jcf.fuse_trajectories(t, odo, t, gps, jcf.FusionParams(**fields))
    fp, ip = tcf.fuse_trajectories(t, odo, t, gps, interop.fusion_params_from(fields),
                                   device="cpu")
    np.testing.assert_allclose(fp, fj, atol=1e-3, rtol=0)
    assert ip["segments"] == ij["segments"]
    assert abs(ip["rmse_after"] - ij["rmse_after"]) < 1e-3
    assert ip["rmse_before"] == ij["rmse_before"]
    if blend:
        assert ip["rmse_after"] < ip["rmse_before"]
        rmse_f = np.sqrt(((fp - truth) ** 2).sum(1).mean())
        rmse_o = np.sqrt(((odo - truth) ** 2).sum(1).mean())
        assert rmse_f < 0.7 * rmse_o
