"""Clouds and an op recorder shared by the cell-list tests; imports
neither JAX nor the JAX package, so the CUDA tests can use it too."""

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def city_cloud(rng, n):
    """A ground plane plus a facade, with the vertical axis first: the
    shape that makes the axis permutation of the spec matter (the
    identity permutation is not the best one)."""
    ng = n * 2 // 3
    g = np.stack([rng.uniform(0, 3000, ng), rng.normal(0, 1, ng),
                  rng.uniform(0, 3000, ng)], axis=1)
    nf = n - ng
    f = np.stack([rng.uniform(0, 3000, nf), rng.uniform(0, 900, nf),
                  np.full(nf, 1500.0) + rng.normal(0, 1, nf)], axis=1)
    return np.concatenate([g, f]).astype(np.float32)[:, [1, 2, 0]]


class DeviceOps(TorchDispatchMode):
    """Records the ops run inside it: the largest output (elements), the
    host reads of CUDA tensors (copies to the CPU, ``.item()``) and the
    scalar reads of any tensor."""

    def __init__(self):
        super().__init__()
        self.largest = 0
        self.cuda_reads = 0
        self.scalar_reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat = out if isinstance(out, (tuple, list)) else [out]
        for t in flat:
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        src = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if func is torch.ops.aten.copy_.default:
            src, flat = args[1], [args[0]]
        if func is torch.ops.aten._local_scalar_dense.default:
            self.scalar_reads += 1
            self.cuda_reads += src is not None and src.is_cuda
        elif (
            src is not None and src.is_cuda
            and any(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in flat)
        ):
            self.cuda_reads += 1
        return out
