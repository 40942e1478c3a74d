"""tpu3dtk_torch — the PyTorch/CUDA port of tpu3dtk for NVIDIA Hopper.

A second package beside ``tpu3dtk`` (the JAX reference, which stays as
it is) with the same layout and contracts: padded ``[N, 3]`` clouds with
masks, strict ``d² < max_dist2`` acceptance, ``.frames`` files
bit-compatible with the AlgoType tags.  Plain tensor code is PyTorch;
every kernel the JAX package wrote in Pallas becomes a hand-written CUDA
kernel under ``csrc/`` (see ``ops/nn_cuda.py``, ``ops/nn_cell_list_cuda.py``).

- ``core``   math3d (numpy/torch backends), Scan
- ``io``     scan directories, formats (text, LAS/LAZ, E57, velodyne
  captures, PLY), .frames, prefetch cache, .oct octree files,
  ConfigFileHough files, PNG and mesh output, the trajectory converters,
  scan differencing, condense / atomize
- ``native`` the host C++ text parser (``csrc/fastscan.cpp``) for ragged
  scan files
- ``ops``    voxel reduction, brute NN and cell-list NN (each a plain
  torch version and a CUDA kernel: K1 ``nn_brute``, K2 ``nn_cell_list``),
  k-NN, the four normal estimators, range/box/segment searches, panorama
  projections (host numpy), surface nets (on the field's device), the
  probabilistic Hough line transform (host numpy), the FAST / ORB /
  SIFT detectors with a brute-force matcher (torch), the offscreen
  renderer (a z-buffer splat in torch, the octree LOD cut), the linear
  octree and spherical quadtree (host numpy), the Bkd forest (K1 a block)
- ``models`` minimizers, ICP (while-style loop, the chained cell-list
  engine, loop-closure windows), sequential registration, LUM graph
  relaxation (on the device and the host path), the correspondence
  cache, ELCH loop closing, the GraphPipeline, out-of-core streaming,
  subgraph SLAM, semi-rigid line-scan registration, the bf16 ICP harness,
  Hough plane detection (SHT, RHT), plane-based registration (preg6d),
  segmentation (FH, region growing, graph cut), the Kalman + Hungarian
  tracker, veloslam, TSDF fusion, IMLS and Poisson meshing, people
  removal, collision detection, GPS and curve fusion, thermal mapping and
  camera calibration, cylinders, building models, occupancy grids and
  floor plans, feature-based registration
- ``parallel`` ``torch.distributed`` process groups: the ICP target and
  the LUM links split over the ranks, their sums taken by ``all_reduce``,
  multi-process launch and per-process scan ingest
- ``utils``  named-phase metrics, key-value config files and scan ranges
- ``cli``    torchslam (the slam6D-style command; sequential ICP, ``-n`` /
  ``-C`` graph LUM, ``-L``/``-G`` GraphPipeline, ``--cache-mb``,
  ``--saveOct``/``--loadOct``; every scan format), torchicpfixpoint,
  torchplanes, torchplanereg, torchnormals, torchscan_red, torchconvert,
  torchexport, torchveloslam, torchrecon, torchshow (the offscreen
  viewer); ``torchslam --distributed`` runs on several processes

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
