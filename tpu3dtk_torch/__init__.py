"""tpu3dtk_torch — the PyTorch/CUDA port of tpu3dtk for NVIDIA Hopper.

A second package beside ``tpu3dtk`` (the JAX reference, which stays as
it is) with the same layout and contracts: padded ``[N, 3]`` clouds with
masks, strict ``d² < max_dist2`` acceptance, ``.frames`` files
bit-compatible with the AlgoType tags.  Plain tensor code is PyTorch;
every kernel the JAX package wrote in Pallas becomes a hand-written CUDA
kernel under ``csrc/`` (see ``ops/nn_cuda.py``, ``ops/nn_cell_list_cuda.py``).

- ``core``   math3d (numpy/torch backends), Scan
- ``io``     scan directories, formats, .frames, prefetch cache
- ``ops``    voxel reduction, brute NN and cell-list NN (each a plain
  torch version and a CUDA kernel: K1 ``nn_brute``, K2 ``nn_cell_list``)
- ``models`` minimizers, ICP (while-style loop, the chained cell-list
  engine, loop-closure windows), sequential registration, LUM graph
  relaxation (on the device and the host path), the correspondence
  cache, ELCH loop closing, the GraphPipeline
- ``utils``  named-phase metrics
- ``cli``    torchslam (the slam6D-style command; sequential ICP, ``-n`` /
  ``-C`` graph LUM, ``-L 4 -G 1`` GraphPipeline)

This package imports neither ``jax`` nor ``tpu3dtk``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device the port runs on when a caller names none: the first
    CUDA card.  The CPU is never chosen implicitly: without a card this
    raises, and a caller who wants the CPU asks for it."""
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "no CUDA device; pass --device cpu / device='cpu' to run on the CPU"
    )
