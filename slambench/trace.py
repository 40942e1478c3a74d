"""Reduction of a ``torch.profiler`` trace to device time by kernel,
the device's busy time and the host's idle gaps.

The arithmetic (union of kernel intervals for the busy share, kernel
time by name) is the one ``chip_smoke.py`` uses, taken over the events
of one profiled job.  Functions on plain lists so that the tests can feed
them hand-made traces.
"""

from __future__ import annotations

import dataclasses
import heapq
import re


@dataclasses.dataclass
class Ev:
    name: str
    start: float  # s
    end: float  # s
    device: bool  # ran on the device (kernel, copy, set)


def events_of(prof) -> list[Ev]:
    """The profiler's events as ``Ev``: device operations, and the host's
    operations, annotations and runtime calls."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    # record_function ranges leave a copy on the device timeline too,
    # which is no device operation: drop device events named as a range
    spans = {e.name() for e in raw if e.device_type() != DeviceType.CUDA and e.is_user_annotation()}
    out = []
    for e in raw:
        s = e.start_ns() * 1e-9
        on_dev = e.device_type() == DeviceType.CUDA
        if on_dev and (e.name() in spans or e.is_user_annotation()):
            continue
        out.append(Ev(e.name(), s, s + e.duration_ns() * 1e-9, on_dev))
    return out


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged [start, end) intervals."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(evs, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which some device operation ran."""
    iv = [(max(e.start, lo), min(e.end, hi)) for e in evs if e.device and e.end > lo and e.start < hi]
    return float(sum(e - s for s, e in union(iv)))


def device_time_by_name(evs) -> dict[str, float]:
    out: dict[str, float] = {}
    for e in evs:
        if e.device:
            out[e.name] = out.get(e.name, 0.0) + (e.end - e.start)
    return out


def idle_gaps(evs, lo: float, hi: float, top: int = 10) -> list[list]:
    """Idle device time in [lo, hi] summed by what the host was doing at
    the middle of each gap: the innermost host event open then (an
    operation, a runtime call or a span), or "host, no event".  Returns
    [[label, seconds], ...], the largest first."""
    busy = union([(e.start, e.end) for e in evs if e.device and e.end > lo and e.start < hi])
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    # innermost open host event at each gap's middle: sweep the middles
    # in order with a max-heap of started events keyed by start, whose
    # closed tops are dropped for good (later middles are later still)
    host = sorted((e for e in evs if not e.device), key=lambda e: e.start)
    heap: list = []
    j = 0
    by: dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        while j < len(host) and host[j].start <= mid:
            heapq.heappush(heap, (-host[j].start, j))
            j += 1
        while heap and host[heap[0][1]].end < mid:
            heapq.heappop(heap)
        label = host[heap[0][1]].name if heap else "host, no event"
        by[label] = by.get(label, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def kernel_base(name: str) -> str:
    """A kernel's own name from the profiler's, which is its whole
    signature: ``(anonymous namespace)::nn_rank_kernel(float const*, ...)``
    gives ``nn_rank_kernel``."""
    name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
    while re.search(r"<[^<>]*>", name):
        name = re.sub(r"<[^<>]*>", "", name)  # template arguments
    return name.split("::")[-1].split(" ")[-1]


def kernel_seconds(device_s: dict, kernels) -> float:
    """Device seconds of the kernels named ``kernels``."""
    return sum(v for k, v in device_s.items() if kernel_base(k) in kernels)


def top_device_ops(evs, top: int = 10) -> list[list]:
    """The device operations that took most time, [[name, seconds], ...];
    a name is cut to its first 120 characters (C++ signatures run long)."""
    return [[k[:120], v] for k, v in sorted(device_time_by_name(evs).items(), key=lambda kv: -kv[1])[:top]]
