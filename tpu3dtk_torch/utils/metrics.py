"""Named-phase metrics — the equivalent of the reference's WITH_METRICS
timers (``ClientMetric``: matching_time, create_tree_time,
on_demand_reduction_time, transform_time, add_frames_time;
include/slam6d/metrics.h:22-126, printed by src/slam6d/metrics.cc:127).

Every ``metrics.time`` timer (a ``with`` block, or a decorator that
times each call of a function) sums host wall time (``perf_counter``)
under its name, with the same named-phase taxonomy so reference and
port runs can be compared phase by phase.  These are host clocks: a
phase that ends in a host read ends synced, one that only enqueues
device work times the enqueue.

While a ``torch.profiler`` records, each timer is also a
``record_function`` range under its name, so the profiler's timeline
(and the device trace beside it) says which phase the host was in.  With
no profiler recording a timer checks one flag and enters no range.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _profiler


class Metric:
    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0

    def add(self, value: float) -> None:
        self.total += value
        self.count += 1

    @property
    def average(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricRegistry:
    """Process-global named timers/counters (ref ClientMetric statics)."""

    def __init__(self) -> None:
        self.timers: dict[str, Metric] = defaultdict(Metric)
        self.counters: dict[str, Metric] = defaultdict(Metric)

    @contextlib.contextmanager
    def time(self, name: str):
        ranged = torch.profiler.record_function(name) if _profiler._is_profiler_enabled else None
        t0 = time.perf_counter()
        try:
            if ranged is None:
                yield
            else:
                with ranged:
                    yield
        finally:
            self.timers[name].add(time.perf_counter() - t0)

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name].add(value)

    def report(self) -> str:
        """Ref ClientMetric::print format: name: sum [s] (count calls)."""
        lines = []
        for name, m in sorted(self.timers.items()):
            lines.append(f"{name}: {m.total:.4f}s ({m.count} calls, avg {m.average*1e3:.2f}ms)")
        for name, m in sorted(self.counters.items()):
            lines.append(f"{name}: {m.total:g} ({m.count} events)")
        return "\n".join(lines)

    def reset(self) -> None:
        self.timers.clear()
        self.counters.clear()


metrics = MetricRegistry()

# the reference's named phases (metrics.h:120-126) that the port records
MATCHING = "matching_time"
REDUCTION = "on_demand_reduction_time"
SCAN_LOAD = "read_scan_time"
# counters of the brute ICP engine (``models.icp.icp_pair``): its
# iterations, and those that ran as a replay of a captured CUDA graph
BRUTE_ICP_ITERATIONS = "brute_icp_iterations"
ICP_GRAPH_REPLAYS = "icp_graph_replays"
# counter of the chained ICP engine (``models.icp.icp_pair_chained``): its
# loop trips that ran as a replay of a captured CUDA graph (the trips
# themselves count under ``models.icp.CHAINED_TRIPS``)
CHAINED_GRAPH_REPLAYS = "chained_graph_replays"
