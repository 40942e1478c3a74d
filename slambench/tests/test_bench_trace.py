"""The trace arithmetic on hand-made traces: busy time as a union of
device intervals, idle gaps by the innermost host event, kernel names
from signatures, and the roofline bound."""

from __future__ import annotations

import pytest

from slambench import peaks, trace
from slambench.metrics import device_idle_pct, k2_roofline_pct
from slambench.trace import Ev


def _evs():
    return [
        Ev("job", 0.0, 10.0, False),
        Ev("entry", 2.0, 10.0, False),
        Ev("aten::mm", 2.5, 3.5, False),
        Ev("cudaLaunchKernel", 2.6, 2.7, False),
        Ev("cudaLaunchKernel", 6.0, 6.1, False),
        Ev("cudaLaunchKernel", 1.0, 1.1, False),
        Ev("(anonymous namespace)::cell_list_items_kernel(float const*, int)", 3.0, 5.0, True),
        Ev("cell_list_init_kernel(unsigned long long*, int)", 4.0, 6.0, True),
        Ev("Memcpy HtoD (Pageable -> Device)", 8.0, 9.0, True),
    ]


def test_union_and_busy():
    assert trace.union([(3, 5), (4, 6), (8, 9), (1, 2)]) == [(1, 2), (3, 6), (8, 9)]
    assert trace.busy_seconds(_evs(), 0.0, 10.0) == pytest.approx(4.0)
    assert trace.busy_seconds(_evs(), 5.0, 8.5) == pytest.approx(1.5)


def test_device_time_by_kernel_name():
    dev = trace.device_time_by_name(_evs())
    assert trace.kernel_seconds(dev, k2_roofline_pct.KERNELS) == pytest.approx(4.0)
    assert trace.kernel_base("void at::native::reduce_kernel<512, 1>(x)") == "reduce_kernel"
    assert trace.top_device_ops(_evs(), top=1)[0][1] == pytest.approx(2.0)


def test_idle_gaps_by_innermost_host_event():
    gaps = dict(trace.idle_gaps(_evs(), 0.0, 10.0))
    # [0,3): middle 1.5 inside job only; [6,8): middle 7 inside entry;
    # [9,10): middle 9.5 inside entry
    assert gaps == pytest.approx({"job": 3.0, "entry": 3.0})
    assert sum(gaps.values()) == pytest.approx(10.0 - trace.busy_seconds(_evs(), 0.0, 10.0))


def test_idle_share_reader():
    ctx = {"profile": {"busy_s": 2.5, "window_s": 10.0}}
    assert device_idle_pct.read(ctx) == pytest.approx(75.0)
    assert device_idle_pct.read({"profile": {"busy_s": 0.0, "window_s": 10.0}}) is None


def test_k2_bound_counts_bytes_of_every_call():
    calls = [(1000, 2000, 3), (500, 500, 2)]
    byts = 3 * (12 * 1000 + 12 * 2000 + 12 * 1000) + 2 * (12 * 500 + 12 * 500 + 12 * 500)
    assert k2_roofline_pct.least_seconds(calls) == pytest.approx(byts / peaks.HBM_BYTES_PER_S)
    ctx = {"profile": {"device_s": {"cell_list_items_kernel(y)": 4 * byts / peaks.HBM_BYTES_PER_S},
                       "record": {"k2_calls": calls}}}
    assert k2_roofline_pct.read(ctx) == pytest.approx(25.0)
    assert k2_roofline_pct.read({"profile": {"device_s": {}, "record": {"k2_calls": calls}}}) is None
