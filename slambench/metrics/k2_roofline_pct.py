"""Kernel K2 (``csrc/nn_cell_list.cu``): the least time the bytes of the
profiled job's K2 calls need (queries and model points read once, index
and d² written once a query), over K2's device time by kernel name.  The
entry counts each call with its queries and model points: a chained
match's loop trips against the previous scan, a chained LUM link call
against its first scan."""

from .. import peaks
from ..trace import kernel_seconds

KERNELS = ("cell_list_init_kernel", "cell_list_items_kernel", "cell_list_unpack_kernel")


def least_seconds(calls) -> float:
    """calls: (queries, model points, number of calls)."""
    byts = sum(n * (12.0 * q + 12.0 * m + peaks.NN_OUT_BYTES * q) for q, m, n in calls)
    return byts / peaks.HBM_BYTES_PER_S


def read(ctx):
    p = ctx["profile"]
    t = kernel_seconds(p["device_s"], KERNELS)
    calls = p["record"].get("k2_calls") or []
    if t <= 0 or not calls:
        return None
    return 100.0 * least_seconds(calls) / t
