"""The port's tracker, veloslam and ``torchveloslam`` against the JAX
package's, on the same numpy inputs made from a seed (the moving scene of
tests/test_veloslam.py), on the CPU (``device="cpu"`` / ``--device cpu``).

Bounds:
- the tracker (host numpy in both): tracks identical after every frame
  (ids, state, covariance, hits, misses), also when it starts from a JAX
  tracker's state carried by ``interop.tracker_from_numpy``;
- ``cluster_features``: extent, height, log count and height above the
  frame's floor identical (f64 numpy in both); planarity, linearity and
  sphericity within 1e-3 of the JAX package's.  Both packages take the
  eigenvalues of the f64 covariance from the closed-form solver in f32
  (the JAX ``sym3_eigenvalues`` casts to f32, tpu3dtk/ops/normals.py:39,
  x64 or not).  Where two eigenvalues are close, arccos near ±1 loses
  half of f32's digits: each package is up to 4.9e-4 off the exact f64
  ratios (``np.linalg.eigvalsh``) over 300 random boxes, the two 4.5e-4
  apart; each is held within 6e-4 of the exact ratios;
- ``VeloSlam`` on the moving scene: per-frame infos equal (moving points,
  clusters, tracks, dynamic tracks, ICP iterations; the ICP error within
  1e-3 cm), poses within 0.05 cm / 1e-4;
- ``torchveloslam`` against ``tpuveloslam`` on the scene written as a uos
  directory: .frames within 0.5 cm / 1e-3, AlgoType tags equal.
"""

import numpy as np
import pytest
import torch

from tests.test_veloslam import _moving_scene
from tpu3dtk.models import tracking as jtrk
from tpu3dtk.models import veloslam as jvelo
from tpu3dtk_torch import interop, synth
from tpu3dtk_torch.io import frames as frames_io
from tpu3dtk_torch.models import tracking as ttrk
from tpu3dtk_torch.models import veloslam as tvelo


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _measurements(rng, n_frames=8):
    """Three objects (one moving 90 cm a frame), noisy, one missed now and
    then, and a clutter detection or two a frame."""
    base = np.array([[0.0, 0.0, 0.0], [500.0, 0.0, 300.0], [-400.0, 50.0, 800.0]])
    frames = []
    for k in range(n_frames):
        objs = base + np.array([[90.0 * k, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
        objs = objs + rng.normal(0, 5.0, objs.shape)
        if k % 3 == 2:
            objs = objs[[0, 2]]
        clutter = rng.uniform(-1500, 1500, (rng.integers(0, 3), 3))
        frames.append(np.concatenate([objs, clutter]))
    return frames


def _track_state(t):
    return (t.track_id, t.x, t.P, t.hits, t.misses, t.start_pos)


def _assert_same_tracks(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        for x, y in zip(_track_state(ta), _track_state(tb)):
            np.testing.assert_array_equal(x, y)


def test_tracker_is_identical_over_frames():
    frames = _measurements(np.random.default_rng(0))
    j = jtrk.MultiObjectTracker(jtrk.TrackerParams())
    t = ttrk.MultiObjectTracker(interop.tracker_params_from(vars(jtrk.TrackerParams())),
                                device="cpu")
    for z in frames:
        _assert_same_tracks(t.step(z), j.step(z))
        assert [x.track_id for x in t.dynamic_tracks()] == [x.track_id for x in j.dynamic_tracks()]
    assert any(j.dynamic_tracks())


def test_tracker_carried_from_jax_state():
    frames = _measurements(np.random.default_rng(1), n_frames=10)
    j = jtrk.MultiObjectTracker(jtrk.TrackerParams(max_misses=2))
    for z in frames[:5]:
        j.step(z)
    state = {
        "params": vars(j.params), "dt": j.dt, "next_id": j._next_id,
        "tracks": [dict(vars(tr)) for tr in j.tracks],
    }
    t = interop.tracker_from_numpy(state)
    for z in frames[5:]:
        _assert_same_tracks(t.step(z), j.step(z))


def test_cluster_features_match_jax():
    rng = np.random.default_rng(0)
    blob = rng.uniform(0, 1, (300, 3)) * np.array([300, 150, 150])
    wall = rng.uniform(0, 1, (300, 3)) * np.array([2000, 2000, 2])
    pole = rng.normal(0, 3, (120, 3)) * np.array([1, 60, 1])
    boxes = [rng.uniform(0, 1, (int(rng.integers(20, 400)), 3))
             * np.maximum(rng.uniform(0.5, 2000, 3) * (rng.uniform(size=3) < 0.8), 1.0)
             for _ in range(40)]
    for pts in (blob, wall, pole, *boxes):
        want = jvelo.cluster_features(pts, frame_min_y=-20.0)
        got = tvelo.cluster_features(pts, frame_min_y=-20.0)
        np.testing.assert_array_equal(got[[0, 1, 2, 6]], want[[0, 1, 2, 6]])
        np.testing.assert_allclose(got[3:6], want[3:6], rtol=0, atol=1e-3)
        c = pts - pts.mean(0)
        lam = np.linalg.eigvalsh(c.T @ c / len(pts))
        exact = np.array([lam[1] - lam[0], lam[2] - lam[1], 3 * lam[0]]) / lam.sum()
        np.testing.assert_allclose(got[3:6], exact, rtol=0, atol=6e-4)
    feats = np.stack([tvelo.cluster_features(p, 0.0) for p in (blob, wall)])
    np.testing.assert_array_equal(tvelo.classify_clusters(feats), jvelo.classify_clusters(feats))


def _scene_for_both():
    scans, _true = _moving_scene(np.random.default_rng(0))
    tscans, _ = interop.scans_from_numpy([
        dict(identifier=s.identifier, xyz=s.xyz, reduced_local=np.asarray(s.reduced_local()),
             transMatOrg=s.transMatOrg, transMat=s.transMat)
        for s in scans
    ])
    return scans, tscans


def test_veloslam_matches_jax_on_the_moving_scene():
    scans, tscans = _scene_for_both()
    kw = dict(tracking=2, sliding_window=3, max_dist_match2=900.0, cluster_threshold=50.0,
              cluster_min_size=15)
    want = jvelo.VeloSlam(jvelo.VeloParams(**kw)).run(scans)
    got = tvelo.VeloSlam(interop.velo_params_from(vars(jvelo.VeloParams(**kw))),
                         device="cpu").run(tscans)
    for a, b in zip(got, want):
        assert a.pop("error", 0.0) == pytest.approx(b.pop("error", 0.0), abs=1e-3)
        assert a == b
    assert any(i.get("n_dynamic", 0) > 0 for i in want[3:])
    for s, t in zip(scans, tscans):
        np.testing.assert_allclose(t.transMat[:3, 3], s.transMat[:3, 3], atol=0.05)
        np.testing.assert_allclose(t.transMat[:3, :3], s.transMat[:3, :3], atol=1e-4)
        assert [f[1] for f in t.frames] == [f[1] for f in s.frames]


def test_cli_matches_jax_cli(tmp_path):
    from tpu3dtk.cli import veloslam as jcli
    from tpu3dtk_torch.cli import veloslam as tcli

    scans, _true = _moving_scene(np.random.default_rng(2), n_frames=5)
    scan_dir = str(tmp_path / "scans")
    idents = synth.write_scan_dir(scan_dir, [s.xyz for s in scans],
                                  [s.transMatOrg for s in scans])
    flags = ["-f", "uos", "-d", "30", "-T", "2", "--window", "3", "-q"]
    outs = {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        out = tmp_path / name
        out.mkdir()
        assert cli.main([scan_dir, *flags, *extra, "--frames-out", str(out)]) == 0
        outs[name] = [frames_io.read_frames(frames_io.frames_path(str(out), i)) for i in idents]
    for (tm, tt), (jm, jt) in zip(outs["torch"], outs["jax"]):
        assert list(tt) == list(jt)
        np.testing.assert_allclose(tm[:, :3, 3], jm[:, :3, 3], atol=0.5)
        np.testing.assert_allclose(tm[:, :3, :3], jm[:, :3, :3], atol=1e-3)
