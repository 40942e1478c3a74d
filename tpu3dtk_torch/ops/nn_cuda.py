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
by device.  The model comes prepared (``ops.nn.BruteModel``, once per
match) or bare, and is then prepared here; around that, one call is two
allocations and one C call that launches three kernels (fill, rank,
accept).  ``nn_brute_kernel.launches`` counts the calls that launched;
a call recorded in a CUDA graph counts once for each replay of the
graph (:class:`CapturedCalls`).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .nn import BruteModel, prepare_brute_model

__all__ = ["CapturedCalls", "nn_brute_kernel", "load"]

_SOURCES = ["nn_brute.cu"]
QB = 512  # queries per block: 128 threads x 4 queries (csrc/nn_brute.cu)
GROUP = 16  # a slice holds whole groups of this many points (csrc/nn_brute.cu)
BLOCKS_PER_SM = 6  # rank blocks to aim for on each SM


_fn = None  # the bound C entry point, after the first load()


def load():
    """Build (once per source hash) and load the kernel library; returns
    its C entry point with its argument types set."""
    global _fn
    if _fn is None:
        fn = cuda_build.load_library("nn_brute", _SOURCES).tpu3dtk_nn_brute_f32
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_void_p] * 5
        )
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


def _slices(Q: int, M: int, blocks: int) -> tuple[int, int]:
    """Model-axis split (S, chunk) for a grid of at most ``blocks`` rank
    blocks: no slice shorter than 256 points, every slice but the last
    ``chunk`` points long, ``chunk`` a whole number of groups."""
    qblocks = -(-Q // QB)
    S = max(1, min(blocks // qblocks, -(-M // 256), 65535))
    chunk = -(-(-(-M // S)) // GROUP) * GROUP
    return -(-M // chunk), chunk


def slices_for(Q: int, M: int, device) -> tuple[int, int]:
    """Model-axis split (S, chunk): as many blocks as fit BLOCKS_PER_SM
    on every SM and no more (one block over leaves most SMs waiting for
    the one that holds it)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _slices(Q, M, BLOCKS_PER_SM * sms)


def _launch(query, qmask, bm: BruteModel, S, chunk, max_dist2, out64, d2, found):
    """The C call on checked arguments: fill, rank and accept kernels on
    the current stream.  ``out64`` is [2, Q] int64: key scratch, then the
    winners' indices."""
    dev = query.device
    fn = load()
    with torch.cuda.device(dev):
        rc = fn(
            query.data_ptr(), qmask.data_ptr(), bm.center.data_ptr(),
            bm.packed.data_ptr(), bm.model.data_ptr(), bm.mmask.data_ptr(),
            query.shape[0], bm.model.shape[0], S, chunk, max_dist2,
            out64.data_ptr(), out64[1].data_ptr(), d2.data_ptr(),
            found.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"nn_brute kernel launch failed: CUDA error {rc}")
    nn_brute_kernel.launches += 1


def nn_brute_kernel(query, qmask, model, mmask, max_dist2):
    """Exact NN of each query among masked model points on the card.

    query [Q,3] f32, qmask [Q] bool; the model as ``model`` [M,3] f32 with
    ``mmask`` [M] bool, or as an ``ops.nn.BruteModel`` (``mmask`` None);
    all contiguous on one CUDA device.  Returns (idx [Q] int64, d2 [Q]
    f32, found [Q] bool), as ``ops.nn.nn_brute``."""
    if not isinstance(query, torch.Tensor) or query.device.type != "cuda":
        raise ValueError("nn_brute_kernel takes CUDA tensors only")
    dev = query.device
    _check("query", query, (3,), torch.float32, dev)
    _check("qmask", qmask, (), torch.bool, dev)
    if isinstance(model, BruteModel):
        if mmask is not None:
            raise ValueError("a BruteModel carries its own mask: pass mmask=None")
        bm = model
    else:
        _check("model", model, (3,), torch.float32, dev)
        _check("mmask", mmask, (), torch.bool, dev)
        bm = prepare_brute_model(model, mmask)
    _check("BruteModel.center", bm.center, (), torch.float32, dev)
    _check("BruteModel.packed", bm.packed, (4,), torch.float32, dev)
    _check("BruteModel.model", bm.model, (3,), torch.float32, dev)
    _check("BruteModel.mmask", bm.mmask, (), torch.bool, dev)
    Q, M = query.shape[0], bm.model.shape[0]
    if bm.center.shape[0] != 3 or bm.packed.shape[0] != M or bm.mmask.shape[0] != M:
        raise ValueError("BruteModel: centre, packed model, model and mask disagree in shape")
    if qmask.shape[0] != Q:
        raise ValueError("mask lengths must match their clouds")
    if M == 0 or M >= 2**31 or Q >= 2**31:
        raise ValueError(f"nn_brute_kernel: {Q} x {M}: empty model or int32 overflow")
    out64 = torch.empty((2, Q), dtype=torch.int64, device=dev)  # key scratch, idx
    d2 = torch.empty(Q, dtype=torch.float32, device=dev)
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    if Q > 0:
        _launch(query, qmask, bm, *slices_for(Q, M, dev), max_dist2, out64, d2, found)
    return out64[1], d2, found


nn_brute_kernel.launches = 0


class CapturedCalls:
    """Calls of a kernel wrapper recorded in a CUDA graph: ``kernel`` is
    the wrapper whose ``launches`` counts its calls (K1's
    ``nn_brute_kernel``, K2's ``cell_list_rows_kernel``).  Inside
    ``with`` the calls of a capture launch nothing, so ``launches``
    leaves them out; :meth:`replayed` counts them once for a replay of
    the graph, which launches them."""

    calls = 0

    def __init__(self, kernel):
        self.kernel = kernel

    def __enter__(self):
        self._before = self.kernel.launches
        return self

    def __exit__(self, *exc):
        self.calls = self.kernel.launches - self._before
        self.kernel.launches = self._before

    def replayed(self) -> None:
        self.kernel.launches += self.calls
