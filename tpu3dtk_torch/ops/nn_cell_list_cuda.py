"""K2 on Hopper: the hand-written CUDA cell-list NN kernel
(``csrc/nn_cell_list.cu``), the port of the TPU kernel
``tpu3dtk/ops/nn_pallas.py::_run_kernel``.

:func:`cell_list_rows_kernel` takes the per-chunk table, the cell-sorted
queries and the cell-sorted model, all contiguous on one CUDA device,
and returns the winning sorted-model row and its score per query.  The
chunks' candidate rows are cut into work items of at most ``ITEM_ROWS``
rows (by the library's init kernel; its plain version is
``ops.nn_cell_list.cell_list_work_items``) that a persistent grid shares
out, so a long chunk does not hold the kernel up and a range may have
any length.  It raises on anything that is not a
CUDA tensor; the plain PyTorch version is
``ops.nn_cell_list.cell_list_rows``, and
``ops.nn_cell_list.cell_list_rows_auto`` picks between the two by
device.  ``cell_list_rows_kernel.launches`` counts the calls that
launched; a call recorded in a CUDA graph counts once for each replay
of the graph (``ops.nn_cuda.CapturedCalls``).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .nn_cuda import _check

__all__ = ["cell_list_rows_kernel", "load"]

_SOURCES = ["nn_cell_list.cu"]
TABLE_COLS = 29  # csrc/nn_cell_list.cu
ITEM_ROWS = 512  # candidate rows per work item
BLOCKS_PER_SM = 8  # size of the persistent grid

_fn = None  # the bound C entry point, after the first load()


def load():
    """Build (once per source hash) and load the kernel library; returns
    its C entry point with its argument types set."""
    global _fn
    if _fn is None:
        lib = cuda_build.load_library("nn_cell_list", _SOURCES)
        fn = lib.tpu3dtk_nn_cell_list_f32
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
        )
        _fn = fn
    return _fn


def _launch(table, q_sorted, model_sorted, chunk, item_rows, blocks,
            scratch, rows, score):
    """The C call on checked arguments: init, items and unpack kernels on
    the current stream.  ``scratch`` is [W*chunk + W + 2] int64: the keys,
    the item counter, and the [W+1] exclusive prefix of the chunks' item
    counts, which the call leaves there."""
    dev = q_sorted.device
    fn = load()
    with torch.cuda.device(dev):
        rc = fn(
            table.data_ptr(), q_sorted.data_ptr(),
            model_sorted.data_ptr(), table.shape[0], chunk,
            model_sorted.shape[0], item_rows, blocks, scratch.data_ptr(),
            rows.data_ptr(), score.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"nn_cell_list kernel launch failed: CUDA error {rc}")
    cell_list_rows_kernel.launches += 1


def cell_list_rows_kernel(table, q_sorted, model_sorted, chunk: int):
    """Sorted-model row and score of each cell-sorted query's nearest
    candidate, on the card.

    table [W, 29] int32, q_sorted [W*chunk, 4] f32, model_sorted
    [Mpad, 4] f32, contiguous on one CUDA device; chunk 128 or 256.
    Returns (rows [W*chunk] int32, score [W*chunk] f32), as
    ``ops.nn_cell_list.cell_list_rows``."""
    if not isinstance(q_sorted, torch.Tensor) or q_sorted.device.type != "cuda":
        raise ValueError("cell_list_rows_kernel takes CUDA tensors only")
    dev = q_sorted.device
    _check("table", table, (TABLE_COLS,), torch.int32, dev)
    _check("q_sorted", q_sorted, (4,), torch.float32, dev)
    _check("model_sorted", model_sorted, (4,), torch.float32, dev)
    if chunk not in (128, 256):
        raise ValueError(f"cell_list_rows_kernel: chunk {chunk} not in (128, 256)")
    W = table.shape[0]
    if W == 0 or q_sorted.shape[0] != W * chunk:
        raise ValueError(
            f"cell_list_rows_kernel: {q_sorted.shape[0]} sorted queries for "
            f"{W} chunks of {chunk}"
        )
    Mrows = model_sorted.shape[0]
    if Mrows == 0 or 9 * Mrows + ITEM_ROWS >= 2**31 or W * chunk >= 2**31:
        raise ValueError("cell_list_rows_kernel: empty model or int32 overflow")
    scratch = torch.empty(W * chunk + W + 2, dtype=torch.int64, device=dev)
    rows = torch.empty(W * chunk, dtype=torch.int32, device=dev)
    score = torch.empty(W * chunk, dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _launch(table, q_sorted, model_sorted, chunk, ITEM_ROWS,
            sms * BLOCKS_PER_SM, scratch, rows, score)
    return rows, score


cell_list_rows_kernel.launches = 0
