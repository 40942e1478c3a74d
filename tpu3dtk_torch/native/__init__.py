"""Native (host C++) runtime components with ctypes bindings — the port
of ``tpu3dtk.native``.

The text-table parser ``csrc/fastscan.cpp`` (the port's own copy of the
JAX package's source) is built with the host compiler at first use,
keyed by the source's hash, into ``build/tpu3dtk_torch/``
(``ops.cuda_build.load_host_library``), never next to the source.  The
scan loader (``io.scandir``) keeps ``numpy.loadtxt`` as its first path
and hands this parser the files numpy rejects (ragged rows, stray
tokens).  Where the JAX package returns None when its build fails, this
module raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

__all__ = ["load", "parse_table"]

_SOURCES = ["fastscan.cpp"]
_lib = None


def load() -> ctypes.CDLL:
    """The parser library, built and bound once per process."""
    global _lib
    if _lib is None:
        from ..ops import cuda_build

        lib = cuda_build.load_host_library("fastscan", _SOURCES)
        lib.parse_table.restype = ctypes.POINTER(ctypes.c_double)
        lib.parse_table.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.free_table.argtypes = [ctypes.POINTER(ctypes.c_double)]
        _lib = lib
    return _lib


def parse_table(path: str, skip_lines: int = 0) -> np.ndarray:
    """Parse a whitespace float table with the native reader.

    Returns [rows, cols] float64.  The column count is the first data
    row's; rows with another count and unparsable tokens are dropped,
    '#' lines are comments, ``skip_lines`` header lines are skipped.  A
    file with no data row gives a [0, cols] array; a missing file
    raises FileNotFoundError."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = load()
    rows = ctypes.c_int64(0)
    cols = ctypes.c_int32(0)
    ptr = lib.parse_table(
        os.fsencode(path), skip_lines, ctypes.byref(rows), ctypes.byref(cols)
    )
    if not ptr:  # no data row
        return np.zeros((0, max(cols.value, 0)), np.float64)
    try:
        n = rows.value * cols.value
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    finally:
        lib.free_table(ptr)
    return arr.reshape(rows.value, cols.value)
