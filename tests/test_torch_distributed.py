"""``torchslam --distributed`` as a real two-process gloo job on
localhost (``--device cpu``), against the one-process run of the same
command: each process reads and reduces its range of the scans
(``parallel.distributed.distributed_ingest``, the random ``-O 1``
reduction seeded per scan as in one process), the sequential matching
runs whole on each, and the ``-G 1`` relaxation splits its links over
both.  tests/test_distributed.py's flags, on a synthetic 6-scan
directory and on the reference scans where they are present.

Bounds: final poses within 1e-2 cm (tests/test_distributed.py:157), the
frames tags equal, only process 0 writing; ``host_scan_range`` equal to
the JAX package's for any split."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tpu3dtk.parallel.distributed import host_scan_range as jrange
from tpu3dtk_torch.io import frames as frames_io
from tpu3dtk_torch.parallel.distributed import host_scan_range as trange
from tpu3dtk_torch.synth import synth_loop, write_scan_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_host_scan_range_matches_jax():
    for n in (0, 1, 5, 7, 468):
        for hosts in (1, 2, 3, 4, 8):
            got = [trange(n, hosts, h) for h in range(hosts)]
            assert got == [jrange(n, hosts, h) for h in range(hosts)]
            assert sorted(i for lo, hi in got for i in range(lo, hi)) == list(range(n))
    assert trange(9) == (0, 9)  # no process group: a world of one


def test_backend_and_card_follow_the_local_layout(monkeypatch):
    """Two hosts of 4 cards, NPROC=8: NCCL, and process 6 on its host's
    card 2 (LOCAL_RANK / LOCAL_WORLD_SIZE as torchrun sets them); one host
    without them: the processes on it are all NPROC, and two processes on
    one card take gloo, both on card 0."""
    from tpu3dtk_torch.parallel.distributed import backend_for, local_layout

    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "2")
    local_rank, local_size = local_layout(8, 6)
    assert (local_rank, local_size) == (2, 4)
    assert backend_for("cuda", local_size, n_cards=4) == "nccl"
    assert backend_for("cpu", local_size, n_cards=4) == "gloo"
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.delenv("LOCAL_RANK")
    assert local_layout(8, 6) == (6, 8)
    assert backend_for("cuda", 8, n_cards=4) == "gloo"
    assert [local_layout(2, r) for r in range(2)] == [(0, 2), (1, 2)]
    assert backend_for("cuda", 2, n_cards=1) == "gloo"
    assert backend_for("cuda", 2, n_cards=2) == "nccl"


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    locs, _true, odo = synth_loop(n_scans=6, n_pts=2000, seed=3)
    d = str(tmp_path_factory.mktemp("dist") / "scans")
    write_scan_dir(d, locs, odo)
    return d


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli(scan_dir, out_dir, flags, env_extra):
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **env_extra)
    cmd = [sys.executable, "-m", "tpu3dtk_torch.cli.slam6d", scan_dir, *flags,
           "--frames-out", out_dir, "--device", "cpu"]
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(procs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


@pytest.mark.parametrize("which", ["synth", "reference"])
def test_two_process_torchslam_matches_one(which, synth_dir, request, tmp_path):
    if which == "reference":
        scan_dir = request.getfixturevalue("dat_dir")
        flags = ["-m", "2500", "-r", "15", "-d", "25", "-i", "20", "-G", "1", "-I", "5", "-q"]
    else:
        scan_dir = synth_dir
        flags = ["-r", "15", "-d", "50", "-i", "20", "-G", "1", "-I", "5", "-q"]
    port = _free_port()
    out_d, out_s = str(tmp_path / "dist"), str(tmp_path / "single")
    procs = [
        _cli(scan_dir, out_d if pid == 0 else out_d + "1", ["--distributed", *flags],
             dict(JAX_COORDINATOR=f"localhost:{port}", NPROC="2", PROC_ID=str(pid)))
        for pid in range(2)
    ]
    procs.append(_cli(scan_dir, out_s, flags, {}))
    logs = _wait(procs)
    for pid in range(2):
        assert f"process {pid} of 2, backend gloo" in logs[pid]
    names = sorted(os.listdir(out_s))
    assert names and names == sorted(os.listdir(out_d))
    assert os.listdir(out_d + "1") == []  # process 1 writes no frames
    for n in names:
        md, td = frames_io.read_frames(os.path.join(out_d, n))
        ms, ts = frames_io.read_frames(os.path.join(out_s, n))
        np.testing.assert_array_equal(td, ts)
        assert int(frames_io.AlgoType.LUM) in set(ts.tolist())
        np.testing.assert_allclose(md[-1], ms[-1], atol=1e-2)


def test_distributed_ingest_single_process_reads_all(synth_dir):
    """Without a process group every scan is read and reduced here, as
    the one-process path reads it."""
    from tpu3dtk_torch.core.scan import Scan
    from tpu3dtk_torch.io.scandir import read_scan_dir
    from tpu3dtk_torch.parallel.distributed import distributed_ingest

    scans = distributed_ingest(synth_dir, reduce_voxel=15.0, octree_n=1, device="cpu")
    ref = [Scan.from_raw(r, device="cpu") for r in read_scan_dir(synth_dir)]
    assert [s.identifier for s in scans] == [s.identifier for s in ref]
    for s, r in zip(scans, ref):
        r.set_reduction(15.0, 1)
        np.testing.assert_array_equal(s.reduced_local(), r.reduced_local())
        np.testing.assert_array_equal(s.transMatOrg, r.transMatOrg)
