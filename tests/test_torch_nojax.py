"""The port runs without JAX: with ``import jax`` made impossible, the
package, its slice modules and the CLI parser still import.  Without a
CUDA card the package's default device raises: the CPU is only used
when it is asked for."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
sys.modules["jax"] = None
import tpu3dtk_torch
from tpu3dtk_torch import interop, synth
from tpu3dtk_torch.cli import slam6d
from tpu3dtk_torch.core import math3d, scan
from tpu3dtk_torch.io import cache, scandir, writer
from tpu3dtk_torch.models import graphslam, icp, minimizers, sequence
from tpu3dtk_torch.models import elch, graph_pipeline, lum_device
from tpu3dtk_torch.ops import cuda_build, nn, nn_cuda, reduction
from tpu3dtk_torch.ops import nn_cell_list, nn_cell_list_cuda
from tpu3dtk_torch.tools import kernel_tuning
assert callable(icp.icp_pair_chained) and callable(synth.synth_city)
assert callable(graphslam.do_graph_slam) and callable(nn_cell_list.cell_list_rows)
assert callable(lum_device.lum_run) and callable(elch.close_loop)
assert callable(graph_pipeline.GraphPipeline().run) and callable(icp.icp_window_align)
assert callable(interop.corr_cache_from_numpy) and callable(graphslam.build_clpairs_graph)
a = slam6d.build_parser().parse_args(["d", "-L", "4", "-G", "1", "--cldist", "300", "--loopsize", "10"])
assert (a.loop6DAlgo, a.graphSlam6DAlgo, a.cldist, a.loopsize) == (4, 1, 300.0, 10)
a = slam6d.build_parser().parse_args(["d", "-n", "g.net", "-I", "5", "-D", "150"])
assert a.net == "g.net" and a.iterSLAM == 5 and a.distSLAM == 150.0
p = slam6d.build_parser()
a = p.parse_args(["somewhere", "-r", "10", "--device", "cpu"])
assert a.reduce == 10.0 and a.device == "cpu"
bad = [m for m in sys.modules if m == "tpu3dtk" or m.startswith("tpu3dtk.")
       or (m.startswith("jax") and sys.modules[m] is not None)]
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    import numpy as np
    import pytest
    import torch

    import tpu3dtk_torch
    from tpu3dtk_torch.cli import slam6d
    from tpu3dtk_torch.models import graphslam
    from tpu3dtk_torch.models.sequence import SequenceRegistration
    from tpu3dtk_torch.ops import nn_cell_list, reduction

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tpu3dtk_torch.default_device()
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reduction.reduce_scan(pts, 10.0, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SequenceRegistration()._device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nn_cell_list.nn_cell_list(pts, np.ones(4, bool), pts, np.ones(4, bool), 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graphslam._do_graph_slam_host([], np.zeros((1, 2), np.int32), graphslam.LumParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graphslam._do_graph_slam_device([], np.zeros((1, 2), np.int32), graphslam.LumParams())
    from tpu3dtk_torch.models import elch, lum_device
    from tpu3dtk_torch.models.graph_pipeline import GraphPipeline

    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphPipeline().run([None])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lum_device.CorrCache(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elch._edge_covariances_euler([], [], elch.ElchParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graphslam.build_clpairs_graph([], 1.0, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slam6d.main([str(tmp_path)])
    assert SequenceRegistration(device="cpu")._device() == torch.device("cpu")
