"""The port runs without JAX: with ``import jax`` made impossible, the
package, its slice modules and the CLI parser still import."""

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
from tpu3dtk_torch.models import icp, minimizers, sequence
from tpu3dtk_torch.ops import cuda_build, nn, nn_cuda, reduction
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
