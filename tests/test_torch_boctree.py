"""The port's ``.oct`` codec (``tpu3dtk_torch.io.boctree``) against the
JAX package's (``tpu3dtk.io.boctree``), and ``torchslam --saveOct`` /
``--loadOct`` against ``tpuslam``'s.

Bounds: the codec is a numpy copy, so the bytes written and the arrays
read are identical (no tolerance).  The CLI round trip registers the
same reduced points in octree order in both packages: final poses
within 0.5 cm translation and 1e-3 on rotation entries (the port's
sequence tests' bound)."""

import os

import numpy as np
import pytest
import torch

from tpu3dtk.cli import slam6d as jcli
from tpu3dtk.io import boctree as jbo
from tpu3dtk.io import frames as jframes
from tpu3dtk_torch.cli import slam6d as tcli
from tpu3dtk_torch.io import boctree as tbo
from tpu3dtk_torch.io import frames as tframes
from tpu3dtk_torch.synth import synth_loop, write_scan_dir
from tests.conftest import make_room_cloud


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds():
    rng = np.random.default_rng(42)
    return {
        "room": (make_room_cloud(rng, n=5000, size=700.0), 10.0),
        "deep": (rng.uniform(0, 1000, (2000, 3)), 1.0),
        "single_leaf": (np.array([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]), 100.0),
        "empty": (np.zeros((0, 3)), 10.0),
    }


@pytest.mark.parametrize("name", ["room", "deep", "single_leaf", "empty"])
def test_write_read_match_jax(name, tmp_path):
    pts, voxel = _clouds()[name]
    jp, tp = str(tmp_path / "j.oct"), str(tmp_path / "t.oct")
    jbo.write_oct(jp, pts, voxel)
    tbo.write_oct(tp, pts, voxel)
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    back = tbo.read_oct(jp)
    np.testing.assert_array_equal(back, jbo.read_oct(jp))
    assert back.shape == (len(pts), 3) and back.dtype == np.float64
    th, jh = tbo.oct_header(jp), jbo.oct_header(jp)
    assert th.keys() == jh.keys()
    for k in th:
        np.testing.assert_array_equal(th[k], jh[k], err_msg=k)


@pytest.fixture(scope="module")
def oct_dirs(tmp_path_factory):
    """One uos directory per package (each --saveOct writes into it)."""
    locs, _true, odo = synth_loop(n_scans=4, n_pts=1500, seed=3)
    out = {}
    for name in ("jax", "torch"):
        d = tmp_path_factory.mktemp(f"oct_{name}")
        write_scan_dir(str(d), locs, odo)
        out[name] = str(d)
    return out


def test_cli_save_then_load_oct_matches_jax(oct_dirs, tmp_path, monkeypatch):
    """--saveOct writes one .oct a scan into the frames directory (here
    the scan directory), with the reduced points and the -r voxel;
    --loadOct then registers those points without reducing again.  Both
    runs of each package against the other's."""
    flags = ["-f", "uos", "-r", "25", "-O", "0", "-d", "50", "-i", "30",
             "--epsICP", "1e-6", "--prefetch", "0", "-q"]
    runs = {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        d = oct_dirs[name]
        assert cli.main([d, *flags, "--saveOct", *extra]) == 0
        octs = sorted(f for f in os.listdir(d) if f.endswith(".oct"))
        assert octs == [f"scan{k:03d}.oct" for k in range(4)]
        saved = {
            f: tframes.final_pose(os.path.join(d, f.replace(".oct", ".frames")))
            for f in octs
        }
        out = tmp_path / name
        out.mkdir()
        if name == "torch":
            from tpu3dtk_torch.ops import reduction

            def no_reduction(*a, **k):
                raise AssertionError("a scan loaded from .oct was reduced again")

            monkeypatch.setattr(reduction, "reduce_scan", no_reduction)
        assert cli.main([d, *flags, "--loadOct", "--frames-out", str(out), *extra]) == 0
        runs[name] = (d, octs, saved, out)
    jd, jocts, jsaved, jout = runs["jax"]
    td, tocts, tsaved, tout = runs["torch"]
    for f in tocts:
        # the same reduced points (-O 0: voxel centres, equal in both
        # packages) give the same octree, byte for byte
        with open(os.path.join(jd, f), "rb") as a, open(os.path.join(td, f), "rb") as b:
            assert a.read() == b.read(), f
        h = tbo.oct_header(os.path.join(td, f))
        assert h["voxel"] == 25.0 and h["pointdim"] == 3
    for f in tocts:
        fr = f.replace(".oct", ".frames")
        for a, b in ((tsaved[f], jsaved[f]),
                     (tframes.final_pose(str(tout / fr)), jframes.final_pose(str(jout / fr)))):
            np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=0.5)
            np.testing.assert_allclose(a[:3, :3], b[:3, :3], atol=1e-3)
