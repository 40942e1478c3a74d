"""tpu3dtk_torch — the PyTorch/CUDA port of tpu3dtk for NVIDIA Hopper.

A second package beside ``tpu3dtk`` (the JAX reference, which stays as
it is) with the same layout and contracts: padded ``[N, 3]`` clouds with
masks, strict ``d² < max_dist2`` acceptance, ``.frames`` files
bit-compatible with the AlgoType tags.  Plain tensor code is PyTorch;
every kernel the JAX package wrote in Pallas becomes a hand-written CUDA
kernel under ``csrc/`` (see ``ops/nn_cuda.py``).

- ``core``   math3d (numpy/torch backends), Scan
- ``io``     scan directories, formats, .frames, prefetch cache
- ``ops``    voxel reduction, brute NN (plain torch + CUDA kernel)
- ``models`` minimizers, ICP, sequential registration
- ``utils``  named-phase metrics
- ``cli``    torchslam (the slam6D-style driver)

This package imports neither ``jax`` nor ``tpu3dtk``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device the port runs on when a caller names none: the first
    CUDA card, or the CPU when there is no card.  This is the only place
    the CPU is chosen implicitly."""
    if torch.cuda.is_available():
        return torch.device("cuda")
    return torch.device("cpu")
