"""The reduced-precision ICP harness: the port's ``models.sc_fixed`` and
``torchicpfixpoint`` against the JAX package's ``sc_fixed`` and
``tpuicpfixpoint``, on the data of tests/test_subgraph_fixed.py.

Both quantize the centred model and the queries to bf16 and rank by a
single bf16 product pass accumulated in f32 (exact products; only the
order of a 3-term sum may differ), so the bf16 neighbour indices are
equal and the quantized ICP runs the same iterations, with poses within
0.01 cm and 1e-5 on rotation entries; the exact-pipeline comparison's
deltas within 0.01 cm.  The fixed path never calls the brute kernel K1's
wrapper."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dtk.core import math3d as jm3
from tpu3dtk.models import sc_fixed as jfx
from tpu3dtk_torch.io import frames as tframes
from tpu3dtk_torch.models import sc_fixed as tfx
from tpu3dtk_torch.synth import write_scan_dir
from tests.conftest import make_room_cloud


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=42, n=4000, size=600.0):
    rng = np.random.default_rng(seed)
    world = make_room_cloud(rng, n=n, size=size)
    T_true = np.asarray(jm3.euler_to_matrix4([6.0, -4.0, 3.0], [0.01, 0.02, -0.015]))
    target = np.asarray(jm3.transform3(jm3.m4inv(T_true), world))
    return world.astype(np.float32), target.astype(np.float32), T_true


def test_nn_bf16_indices_match_jax():
    model, target, T_true = _pair()
    rng = np.random.default_rng(1)
    mmask = rng.uniform(size=len(model)) > 0.1
    qmask = rng.uniform(size=len(target)) > 0.05
    query = (target @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    query += rng.normal(0, 2.0, query.shape).astype(np.float32)
    qm = tfx._quantize_model(torch.as_tensor(model), torch.as_tensor(mmask))
    # one centre for both: its f32 sum's last bit moves bf16 roundings
    center = jnp.asarray(qm.center.numpy())
    jidx, jfound, jmf = jfx._nn_bf16(
        jnp.asarray(query), jnp.asarray(qmask),
        (jnp.asarray(model) - center).astype(jnp.bfloat16),
        jnp.asarray(mmask), center, jnp.float32(100.0),
    )
    tidx, tfound, tmf = tfx._nn_bf16(torch.as_tensor(query), torch.as_tensor(qmask), qm, 100.0)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_allclose(tmf.numpy(), np.asarray(jmf), rtol=0, atol=1e-4)
    assert 0 < int(tfound.sum()) < len(query)


def test_icp_pair_fixed_matches_jax(monkeypatch):
    from tpu3dtk_torch.ops import nn_cuda

    def no_k1(*a, **k):
        raise AssertionError("the fixed path reached the brute kernel K1")

    monkeypatch.setattr(nn_cuda, "nn_brute_kernel", no_k1)
    model, target, T_true = _pair()
    ones = np.ones(len(model), bool)
    jr = jfx.icp_pair_fixed(
        jnp.asarray(model), jnp.asarray(ones), jnp.asarray(target), jnp.asarray(ones),
        jnp.eye(4, dtype=jnp.float32), 625.0, max_iterations=60, eps_exp=5,
    )
    t1 = torch.ones(len(model), dtype=torch.bool)
    tr = tfx.icp_pair_fixed(
        torch.as_tensor(model), t1, torch.as_tensor(target), t1,
        torch.eye(4), 625.0, max_iterations=60, eps_exp=5,
    )
    assert tr.iterations == int(jr.iterations) > 1
    assert tr.n_pairs == float(jr.n_pairs)
    T, jT = tr.T.numpy(), np.asarray(jr.T)
    np.testing.assert_allclose(T[:3, 3], jT[:3, 3], atol=0.01)
    np.testing.assert_allclose(T[:3, :3], jT[:3, :3], atol=1e-5)
    assert abs(tr.error - float(jr.error)) < 1e-4
    # bf16 resolution of ~±300 cm coordinates: within 3 cm of the truth
    assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 3.0


def test_compare_fixed_float_matches_jax():
    model, target, _ = _pair(seed=7, n=3000, size=500.0)
    kw = dict(max_iterations=50)
    j = jfx.compare_fixed_float(model, target, np.eye(4, dtype=np.float32), 625.0, **kw)
    t = tfx.compare_fixed_float(model, target, np.eye(4, dtype=np.float32), 625.0,
                                device="cpu", **kw)
    assert t["iterations_fixed"] == j["iterations_fixed"]
    assert abs(t["iterations_float"] - j["iterations_float"]) <= 1
    assert abs(t["delta_translation_cm"] - j["delta_translation_cm"]) < 0.01
    assert abs(t["delta_rotation_fro"] - j["delta_rotation_fro"]) < 1e-5
    for k in ("T_fixed", "T_float"):
        np.testing.assert_allclose(t[k][:3, 3], j[k][:3, 3], atol=0.01)


def test_cli_compare_matches_jax_cli(tmp_path):
    from tpu3dtk.cli import icp_fixpoint as jcli
    from tpu3dtk_torch.cli import icp_fixpoint as tcli

    # tests/test_streaming.py's walk through a room (odometry ~1 cm off):
    # the exact pipeline's JAX NN ranks in bf16 passes, so its poses are
    # compared where pairs are many and the minimum is well defined
    rng = np.random.default_rng(42)
    room = make_room_cloud(rng, n=2400, size=1200.0)
    locs, odo = [], []
    for k in range(4):
        off = np.array([k * 10.0, 0.0, k * 6.0])
        locs.append(room - off + rng.normal(0, 0.5, room.shape))
        odo.append(np.asarray(jm3.euler_to_matrix4(off + rng.normal(0, 1.0, 3), np.zeros(3))))
    d = tmp_path / "scans"
    write_scan_dir(str(d), locs, odo)
    flags = ["-r", "15", "-O", "0", "-d", "50", "-i", "30", "--epsExp", "4", "--compare"]
    outs, texts = {}, {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        out = tmp_path / name
        out.mkdir()
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main([str(d), *flags, "--frames-out", str(out), *extra]) == 0
        outs[name], texts[name] = out, buf.getvalue()
    pat = r"scan (\d+): bf16-vs-f32 delta ([\d.]+) cm\nscan \1: ITER (\d+) err ([\d.]+) pairs (\d+)"
    jl, tl = re.findall(pat, texts["jax"]), re.findall(pat, texts["torch"])
    assert len(tl) == len(jl) == 3
    for (ji, jd, jit, _je, jp), (ti, td, tit, _te, tp) in zip(jl, tl):
        assert (ti, tit, tp) == (ji, jit, jp)
        assert abs(float(td) - float(jd)) < 0.01
    names = sorted(os.listdir(outs["torch"]))
    assert names == sorted(os.listdir(outs["jax"])) and len(names) == 4
    for n in names:
        a = tframes.final_pose(str(outs["torch"] / n))
        b = tframes.final_pose(str(outs["jax"] / n))
        np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=0.01)
        np.testing.assert_allclose(a[:3, :3], b[:3, :3], atol=1e-5)
