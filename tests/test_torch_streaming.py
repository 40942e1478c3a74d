"""Out-of-core streaming registration (``torchslam --cache-mb``): the
port's ``models.streaming.register_streaming`` against the JAX
package's on one small uos directory.

Both reduce with ``-O 0`` (voxel centres, equal in both packages; the
random modes draw from different generators) and match window 1 with
the quat minimizer.  Bounds: poses within 0.5 cm translation and 1e-3
on rotation entries (the port's sequence tests' bound), iterations ±1
a match; resident scan bytes bounded as in tests/test_streaming.py
(the raw payloads die, the cache stays within its budget)."""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

from tpu3dtk.io.cache import ScanCache as JScanCache
from tpu3dtk.models.icp import IcpParams as JIcpParams
from tpu3dtk.models.streaming import register_streaming as j_register
from tpu3dtk_torch.io import frames as tframes
from tpu3dtk_torch.io.cache import ScanCache
from tpu3dtk_torch.models.icp import IcpParams
from tpu3dtk_torch.models.streaming import register_streaming
from tests.conftest import make_room_cloud

N_SCANS = 8
N_PTS = 2400


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scan_dir(tmp_path_factory):
    """tests/test_streaming.py's walk through a room, shorter and
    sparser: 8 scans of 2400 points, odometry off by ~1 cm."""
    rng = np.random.default_rng(42)
    d = tmp_path_factory.mktemp("stream")
    room = make_room_cloud(rng, n=N_PTS, size=1200.0)
    for k in range(N_SCANS):
        off = np.array([k * 10.0, 0.0, k * 6.0])
        local = room - off + rng.normal(0, 0.5, room.shape)
        np.savetxt(d / f"scan{k:03d}.3d", local, fmt="%.1f")
        drift = rng.normal(0, 1.0, 3)
        (d / f"scan{k:03d}.pose").write_text(
            f"{off[0]+drift[0]} {off[1]+drift[1]} {off[2]+drift[2]}\n0 0 0\n"
        )
    return str(d)


def test_streaming_matches_jax_with_bounded_memory(scan_dir, tmp_path):
    import tpu3dtk_torch.io.cache as cache_mod

    kw = dict(format="uos", reduction=(15.0, 0))
    jres = j_register(
        scan_dir, params=JIcpParams(max_dist_match2=2500.0, max_iterations=30,
                                    epsilon=1e-6),
        cache=JScanCache(64 << 10), **kw,
    )
    # a budget well below the sequence's reduced clouds forces eviction
    budget = 64 << 10
    cache = ScanCache(budget)
    live = []
    orig_read = cache_mod.read_scan

    def tracking_read(*a, **k):
        raw = orig_read(*a, **k)
        for v in raw.channels.values():
            live.append((weakref.ref(v), v.nbytes))
        return raw

    cache_mod.read_scan = tracking_read
    try:
        tres = register_streaming(
            scan_dir, params=IcpParams(max_dist_match2=2500.0, max_iterations=30,
                                       epsilon=1e-6),
            cache=cache, frames_out=str(tmp_path), device="cpu", **kw,
        )
        gc.collect()
        peak = sum(nb for r, nb in live if r() is not None)
    finally:
        cache_mod.read_scan = orig_read

    assert len(tres) == len(jres) == N_SCANS
    for j, t in zip(jres, tres):
        assert t["identifier"] == j["identifier"]
        np.testing.assert_allclose(t["pose"][:3, 3], j["pose"][:3, 3], atol=0.5)
        np.testing.assert_allclose(t["pose"][:3, :3], j["pose"][:3, :3], atol=1e-3)
        assert abs(t["iterations"] - j["iterations"]) <= 1
        # registered against scan 0, which keeps its odometry pose
        want = np.array([int(t["identifier"]) * 10.0, 0.0, int(t["identifier"]) * 6.0])
        assert np.linalg.norm(t["pose"][:3, 3] - tres[0]["pose"][:3, 3] - want) < 3.0
    # the raw payloads died; the cache holds host arrays within its budget
    assert peak < N_SCANS * N_PTS * 3 * 8 / 4
    assert 0 < cache._bytes <= budget and len(cache) < N_SCANS
    # .frames: one line, the final pose, tagged ICP (2)
    for t in tres:
        mats, types = tframes.read_frames(tframes.frames_path(str(tmp_path), t["identifier"]))
        assert list(types) == [2]
        np.testing.assert_allclose(mats[-1], t["pose"], atol=1e-5)


def test_cli_cache_mb_matches_jax_cli(scan_dir, tmp_path):
    """torchslam --cache-mb against tpuslam --cache-mb; -a 2 and -R 3 are
    given and ignored by both (the streaming ICP takes -d, -i and
    --epsICP only)."""
    from tpu3dtk.cli import slam6d as jcli
    from tpu3dtk_torch.cli import slam6d as tcli

    flags = ["-r", "15", "-O", "0", "-d", "50", "-i", "20", "--epsICP", "1e-6",
             "--cache-mb", "1", "-a", "2", "-R", "3", "-q"]
    outs = {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        out = tmp_path / name
        out.mkdir()
        assert cli.main([scan_dir, *flags, "--frames-out", str(out), *extra]) == 0
        outs[name] = out
    names = sorted(os.listdir(outs["torch"]))
    assert names == sorted(os.listdir(outs["jax"]))
    assert names == [f"scan{k:03d}.frames" for k in range(N_SCANS)]
    for n in names:
        a = tframes.final_pose(str(outs["torch"] / n))
        b = tframes.final_pose(str(outs["jax"] / n))
        np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=0.5)
        np.testing.assert_allclose(a[:3, :3], b[:3, :3], atol=1e-3)
