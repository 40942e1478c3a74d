"""The port's numpy-only sequence generators give exactly the arrays of
scripts/make_golden.py (same seeds, same draws, same pose formulas)."""

import os
import sys

import numpy as np
import pytest

from tpu3dtk_torch import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import make_golden  # noqa: E402


@pytest.mark.parametrize(
    "name,kw",
    [
        ("synth_loop", dict(n_scans=5, n_pts=500, seed=7)),
        ("synth_ring", dict(n_scans=3, n_pts=400, seed=11)),
        ("synth_city", dict(n_scans=2, n_pts=2000, seed=23)),
    ],
)
def test_synth_equals_make_golden(name, kw):
    got = getattr(synth, name)(**kw)
    want = getattr(make_golden, name)(**kw)
    for g, w in zip(got, want):
        assert len(g) == len(w) == kw["n_scans"]
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_synth_ring_renders_a_prefix():
    """``n_render`` makes the ring's first scans only: the same arrays as
    the whole ring's first scans."""
    full = synth.synth_ring(n_scans=6, n_pts=400, seed=11)
    part = synth.synth_ring(n_scans=6, n_pts=400, seed=11, n_render=2)
    for g, w in zip(part, full):
        assert len(g) == 2
        for a, b in zip(g, w[:2]):
            np.testing.assert_array_equal(a, b)


def test_write_scan_dir_roundtrip(tmp_path):
    from tpu3dtk_torch.core.scan import Scan
    from tpu3dtk_torch.io.scandir import read_scan_dir

    locs, _true, odo = synth.synth_loop(n_scans=2, n_pts=300, seed=1)
    synth.write_scan_dir(str(tmp_path), locs, odo)
    raws = list(read_scan_dir(str(tmp_path), format="uos"))
    assert [r.identifier for r in raws] == ["000", "001"]
    for raw, loc, To in zip(raws, locs, odo):
        np.testing.assert_allclose(raw.xyz, loc, atol=1e-5)
        np.testing.assert_allclose(
            Scan.from_raw(raw, device="cpu").transMatOrg, To, atol=1e-9
        )


def test_net_file_roundtrip(tmp_path):
    from tpu3dtk.models.graphslam import read_net_graph as jax_read
    from tpu3dtk_torch.models.graphslam import read_net_graph

    links = [(i, i + 1) for i in range(12)] + [(0, 12)]
    path = str(tmp_path / "bremen.net")
    synth.write_net_graph(path, 13, links)
    assert open(path).read().split()[:2] == ["13", "13"]
    np.testing.assert_array_equal(read_net_graph(path), links)
    np.testing.assert_array_equal(jax_read(path), links)


def test_synth_linescans_equals_test_srr():
    """The line-scan generator reproduces tests/test_srr.py::_make_linescans
    (same draws; pose formulas of both packages' numpy math3d)."""
    from tests.test_srr import _make_linescans

    ls, true_poses = _make_linescans(np.random.default_rng(42), L=12, pts_per_line=300)
    locs, true_mats, odo_mats = synth.synth_linescans(n_lines=12, pts_per_line=300, seed=42)
    assert len(locs) == 12 and all(p.shape == (300, 3) for p in locs)
    np.testing.assert_allclose(np.stack(locs), ls.points, rtol=0, atol=1e-4)
    np.testing.assert_allclose(true_mats, true_poses, rtol=0, atol=1e-12)
    np.testing.assert_allclose(odo_mats, ls.poses_org, rtol=0, atol=1e-12)
    assert ls.masks.all()


def test_velodyne_box_changes_only_the_returns_it_blocks():
    """A box obstacle changes exactly the returns whose ray hits it first:
    those come back shorter and on the box's faces; every other return is
    byte-identical to the capture of the empty room."""
    from tpu3dtk_torch.core import math3d
    from tpu3dtk_torch.io import velodyne

    T = np.asarray(math3d.euler_to_matrix4(np.array([30.0, 0.0, -20.0]),
                                           np.array([0.0, 0.3, 0.0]), xp=np))
    (box,) = synth.velodyne_mover(3)[2]
    empty = synth.velodyne_capture(T)
    boxed = synth.velodyne_capture(T, boxes=[box])
    ret = lambda cap: np.frombuffer(cap, synth._BLOCK)["fire"]["ret"]  # noqa: E731
    a, b = ret(empty), ret(boxed)
    changed = a["dist"] != b["dist"]
    assert changed.sum() > 1000
    assert (b["dist"][changed] < a["dist"][changed]).all()
    np.testing.assert_array_equal(a[~changed], b[~changed])
    # the changed returns decode onto the box's faces (2 mm LSB)
    xyz = velodyne.decode_velodyne(boxed)["xyz"]
    w = np.asarray(math3d.transform3(T, xyz))
    lo, hi = box
    on_box = np.all((w >= lo - 0.3) & (w <= hi + 0.3), axis=1)
    face = np.minimum(np.abs(w - lo), np.abs(w - hi)).min(1)
    assert on_box.sum() == changed.sum()
    assert face[on_box].max() <= 0.3


def test_building_room_openings_hold_no_points():
    """synth.building_room's doors and windows let every ray through: no
    point lies inside an opening (shrunk by 3 sigma of the 0.5 cm noise),
    while the wall around each opening is sampled."""
    pts, centre, boxes = synth.building_room(n_pts=400_000, seed=37)
    assert len(boxes) == 6 and {b[4] for b in boxes} == {"door", "window"}
    assert np.allclose(centre, 0.5 * (synth.VELO_ROOM_LO + synth.VELO_ROOM_HI))
    margin = 1.5
    for ax, _side, lo, hi, _kind in boxes:
        pad = np.full(3, -margin)
        pad[ax] = 3 * margin  # across the wall: the wall's own noise band
        inside = np.all((pts > lo - pad) & (pts < hi + pad), axis=1)
        assert inside.sum() == 0
        ring = np.full(3, 30.0)
        ring[ax] = 3 * margin
        near = np.all((pts > lo - ring) & (pts < hi + ring), axis=1)
        assert near.sum() > 20
