"""K1 on Hopper: the hand-written CUDA brute-force NN kernel
(``csrc/nn_brute.cu``), the port of the TPU kernel
``tpu3dtk/ops/nn_pallas.py::_nn_mxu_kernel`` and its wrapper
``nn_brute_mxu``.

:func:`nn_brute_kernel` keeps the ``nn_brute_mxu`` contract: both
clouds centred on the masked model mean, exact f32 ranking, lowest index
on ties, the winner's d² recomputed from the uncentred coordinates, and
``found = qmask & mmask[idx] & (d2 < max_dist2)``.  It takes CUDA
tensors only and raises on anything else; the plain PyTorch version is
``ops.nn.nn_brute``, and ``ops.nn.nn_brute_auto`` picks between the two
by device.  ``nn_brute_kernel.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .nn import accept, masked_center

__all__ = ["nn_brute_kernel", "load"]

_SOURCES = ["nn_brute.cu"]
BQ = 128  # queries per block (csrc/nn_brute.cu)
BLOCKS_PER_SM = 16  # partial-pass blocks to aim for on each SM


_fn = None  # the bound C entry point, after the first load()


def load():
    """Build (once per source hash) and load the kernel library; returns
    its C entry point with its argument types set."""
    global _fn
    if _fn is None:
        fn = cuda_build.load_library("nn_brute", _SOURCES).tpu3dtk_nn_brute_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        _fn = fn
    return _fn


def _check(name, t, shape_tail, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != 1 + len(shape_tail) or tuple(t.shape[1:]) != shape_tail:
        raise ValueError(f"{name}: expected shape [N, *{shape_tail}], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def slices_for(Q: int, M: int, device) -> int:
    """Model-axis split S: enough blocks for BLOCKS_PER_SM on every SM,
    and no slice shorter than one 256-point stretch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    qblocks = -(-Q // BQ)
    want = -(-(BLOCKS_PER_SM * sms) // qblocks)
    return max(1, min(want, -(-M // 256), 65535))


def nn_brute_kernel(query, qmask, model, mmask, max_dist2):
    """Exact NN of each query among masked model points on the card.

    query [Q,3] f32, qmask [Q] bool, model [M,3] f32, mmask [M] bool, all
    contiguous on one CUDA device.  Returns (idx [Q] int64, d2 [Q] f32,
    found [Q] bool), as ``ops.nn.nn_brute``."""
    if not isinstance(query, torch.Tensor) or query.device.type != "cuda":
        raise ValueError("nn_brute_kernel takes CUDA tensors only")
    dev = query.device
    _check("query", query, (3,), torch.float32, dev)
    _check("model", model, (3,), torch.float32, dev)
    _check("qmask", qmask, (), torch.bool, dev)
    _check("mmask", mmask, (), torch.bool, dev)
    Q, M = query.shape[0], model.shape[0]
    if qmask.shape[0] != Q or mmask.shape[0] != M:
        raise ValueError("mask lengths must match their clouds")
    if M == 0:
        raise ValueError("nn_brute_kernel: empty model")
    if Q == 0:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return accept(query, qmask, model, mmask, empty, max_dist2)
    S = slices_for(Q, M, dev)
    if S * Q >= 2**31:
        raise ValueError(f"nn_brute_kernel: {Q} queries x {S} slices overflow int32")

    center = masked_center(model, mmask)
    q4 = torch.zeros((Q, 4), dtype=torch.float32, device=dev)
    q4[:, :3] = query - center
    m4 = torch.empty((M, 4), dtype=torch.float32, device=dev)
    m4[:, :3] = model - center
    m4[:, 3] = torch.where(mmask, 0.0, float("inf"))
    part_d2 = torch.empty((S, Q), dtype=torch.float32, device=dev)
    part_idx = torch.empty((S, Q), dtype=torch.int32, device=dev)
    idx = torch.empty(Q, dtype=torch.int32, device=dev)

    fn = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            q4.data_ptr(), m4.data_ptr(), Q, M, S,
            part_d2.data_ptr(), part_idx.data_ptr(), idx.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"nn_brute kernel launch failed: CUDA error {rc}")
    nn_brute_kernel.launches += 1
    return accept(query, qmask, model, mmask, idx.long(), max_dist2)


nn_brute_kernel.launches = 0
