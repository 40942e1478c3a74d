"""``torchshow --device cpu`` against ``tpushow`` on one 3-scan directory
with a ``.frames`` history a scan: every colour mode, ``--lod``,
``--orbit``, ``--animate``, ``--frameno``, ``--pointsize`` and
``--loadOct``.

Bound: every PNG equal to the JAX package's, pixel for pixel (the
render bound of tests/test_torch_render.py).  Reductions use ``-O 0``
(voxel centres, the same in both packages; ``-O 1`` draws from
different generators, ROADMAP "Deliberate differences")."""

import os

import numpy as np
import pytest
import torch

from tpu3dtk.cli import show as jshow
from tpu3dtk_torch.cli import show as tshow
from tpu3dtk_torch.core import math3d
from tpu3dtk_torch.io import frames as frames_io
from tpu3dtk_torch.io.boctree import write_oct
from tpu3dtk_torch.io.png import read_png
from tpu3dtk_torch.synth import synth_loop, write_scan_dir


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Three scans as uos (with .oct caches) and as uosr (with a
    reflectance channel), each with a 4-frame history ending near its
    true pose."""
    locs, true, odo = synth_loop(n_scans=3, n_pts=3000, seed=4)
    rng = np.random.default_rng(4)
    root = tmp_path_factory.mktemp("show")
    uos, uosr = str(root / "uos"), str(root / "uosr")
    write_scan_dir(uos, locs, odo)
    os.makedirs(uosr)
    for k, (pts, To, Tt) in enumerate(zip(locs, odo, true)):
        ident = f"{k:03d}"
        refl = rng.uniform(0, 1000, (len(pts), 1))
        np.savetxt(os.path.join(uosr, f"scan{ident}.3d"), np.hstack([pts, refl]), fmt="%.3f")
        os.link(os.path.join(uos, f"scan{ident}.pose"), os.path.join(uosr, f"scan{ident}.pose"))
        hist = np.stack([To, 0.6 * To + 0.4 * Tt, 0.2 * To + 0.8 * Tt, Tt])
        for d in (uos, uosr):
            frames_io.write_frames(frames_io.frames_path(d, ident), hist, [1] * 4)
        write_oct(os.path.join(uos, f"scan{ident}.oct"), np.asarray(pts)[::3], 20.0)
    return {"uos": uos, "uosr": uosr}


CASES = {
    "height": (["-r", "10", "-O", "0", "--orbit", "2", "--pointsize", "3"], "uos"),
    "depth": (["--color", "depth", "--orbit", "1", "--animate", "3"], "uos"),
    "scan": (["--color", "scan", "-r", "10", "-O", "0", "--orbit", "2"], "uos"),
    "reflectance": (["--color", "reflectance", "--orbit", "1", "-f", "uosr"], "uosr"),
    "lod": (["--lod", "3000", "--orbit", "2"], "uos"),
    "loadOct": (["--loadOct", "--orbit", "1", "--animate", "2"], "uos"),
    "frameno": (["--frameno", "0", "--orbit", "1", "-m", "2000", "--fov", "75"], "uos"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_torchshow_matches_tpushow(case, scene, tmp_path, capsys):
    flags, d = CASES[case]
    flags = flags + ["--width", "96", "--height", "72"]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jshow.main([scene[d], *flags, "-o", out_j]) == 0
    assert tshow.main([scene[d], *flags, "-o", out_t, "--device", "cpu"]) == 0
    assert "falling back" not in capsys.readouterr().err
    names = sorted(os.listdir(out_j))
    assert names == sorted(os.listdir(out_t)) and names
    drawn = 0
    for name in names:
        a, b = read_png(os.path.join(out_j, name)), read_png(os.path.join(out_t, name))
        assert a.shape == b.shape == (72, 96, 3)
        np.testing.assert_array_equal(b, a, err_msg=name)
        drawn += int(b.any(-1).sum())
    assert drawn > 100


def test_torchshow_needs_a_card_or_cpu(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tshow.main([scene["uos"], "--orbit", "1", "-o", str(tmp_path)])


def test_world_points_apply_the_frame():
    pts = [np.array([[1.0, 2.0, 3.0]]), np.array([[0.0, 0.0, 1.0]])]
    hist = [np.stack([np.eye(4), math3d.euler_to_matrix4(np.array([5.0, 0, 0]), np.zeros(3), xp=np)]),
            np.eye(4)[None]]
    np.testing.assert_array_equal(tshow.world_points(pts, hist, -1), jshow.world_points(pts, hist, -1))
    np.testing.assert_array_equal(tshow.world_points(pts, hist, 0), [[1.0, 2.0, 3.0], [0.0, 0.0, 1.0]])
