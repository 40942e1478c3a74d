"""Named-phase metrics — the equivalent of the reference's WITH_METRICS
timers (``ClientMetric``: matching_time, create_tree_time,
on_demand_reduction_time, transform_time, add_frames_time;
include/slam6d/metrics.h:22-126, printed by src/slam6d/metrics.cc:127).

Always-on (cheap), wall-clock based, with the same named-phase taxonomy
so reference and port runs can be compared phase by phase.  These are
host clocks: for device timing use CUDA events or torch.profiler around
the phases of interest.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


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
        t0 = time.perf_counter()
        try:
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

# the reference's named phases (metrics.h:120-126)
MATCHING = "matching_time"
REDUCTION = "on_demand_reduction_time"
TREE = "create_tree_time"
TRANSFORM = "transform_time"
FRAMES = "add_frames_time"
SCAN_LOAD = "read_scan_time"
