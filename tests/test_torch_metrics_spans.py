"""The port's one tracer, ``utils.metrics``: every ``metrics.time`` timer
is a ``record_function`` range while a profiler records, and nothing
more than a timer while none does.

- no profiler recording: no ``record_function`` (patched to raise);
- the same timer names and counts with a profiler and without; under a
  CPU ``torch.profiler`` each timer's call is a user annotation of its
  name, children inside their parents, their durations the timer's
  total within 1 ms; a timer opened before the profiler starts is no
  range;
- the program's timers on a tiny CPU run: ``GraphPipeline`` (18 scans
  of ``synth.synth_loop``, ELCH and LUM) under a profiler gives one
  ``scan_step_time`` range a scan with its match inside it, ELCH inside
  ``closure_time``, a ``lum_relax_time`` per closure and for the final
  relax, and the poses and frames of the same run with no profiler, bit
  for bit; a chained ``SequenceRegistration`` sizes its cell list inside
  ``sequence_prepare_time``; ``Scan.reduced_local`` times the reduction
  it computes, and only that one.
"""

import time

import numpy as np
import pytest
import torch

from tpu3dtk_torch import synth
from tpu3dtk_torch.core.scan import Scan
from tpu3dtk_torch.models.graph_pipeline import GraphPipeline
from tpu3dtk_torch.models.icp import IcpParams
from tpu3dtk_torch.models.sequence import SequenceRegistration
from tpu3dtk_torch.utils.metrics import REDUCTION, MetricRegistry, metrics

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The clouds here are small: one intra-op thread is faster than
    eight, and does not fight the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nested(reg):
    with reg.time("outer"):
        time.sleep(0.002)
        with reg.time("mid"):
            with reg.time("inner"):
                time.sleep(0.002)
        with reg.time("mid"):
            pass


def _ranges(prof):
    """The profile's user annotations as (name, start_ns, end_ns), in
    order of start."""
    ev = (e for e in prof.profiler.kineto_results.events() if e.is_user_annotation())
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in ev), key=lambda r: r[1])


def _inside(r, outer):
    return outer[1] <= r[1] and r[2] <= outer[2]


def test_no_range_when_no_profiler_records(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    reg = MetricRegistry()
    _nested(reg)
    _nested(reg)
    assert {k: m.count for k, m in reg.timers.items()} == {"outer": 2, "mid": 4, "inner": 2}
    assert reg.timers["outer"].total >= reg.timers["mid"].total >= reg.timers["inner"].total >= 0.004


def test_totals_and_counts_do_not_depend_on_the_profiler():
    off, on = MetricRegistry(), MetricRegistry()
    _nested(off)
    with torch.profiler.profile(activities=CPU):
        _nested(on)
    assert {k: m.count for k, m in off.timers.items()} == {k: m.count for k, m in on.timers.items()}
    for reg in (off, on):
        assert reg.timers["outer"].total >= reg.timers["mid"].total >= reg.timers["inner"].total >= 0.002


def test_timers_stand_on_the_profiler_timeline():
    reg = MetricRegistry()

    @reg.time("decorated")
    def f(x):
        with reg.time("in_f"):
            return x + 1

    with torch.profiler.profile(activities=CPU) as prof:
        _nested(reg)
        with reg.time("outer"):
            assert f(1) == 2
        assert f(2) == 3
    got = _ranges(prof)
    assert [r[0] for r in got] == ["outer", "mid", "inner", "mid", "outer", "decorated", "in_f", "decorated",
                                   "in_f"]
    for child, parent in [(1, 0), (2, 1), (3, 0), (5, 4), (6, 5), (8, 7)]:
        assert _inside(got[child], got[parent])
    # each timer's total is its ranges' time, to the clocks' difference
    for name, m in reg.timers.items():
        ns = sum(b - a for n, a, b in got if n == name)
        assert abs(ns * 1e-9 - m.total) < 1e-3


def test_a_timer_opened_before_the_profiler_is_no_range():
    reg = MetricRegistry()
    with reg.time("early"):
        with torch.profiler.profile(activities=CPU) as prof:
            with reg.time("late"):
                pass
    assert [r[0] for r in _ranges(prof)] == ["late"]
    assert reg.timers["early"].count == reg.timers["late"].count == 1


# -- the program's spans ---------------------------------------------------

N_SCANS = 18


def _scans():
    locs, _true, odo = synth.synth_loop(n_scans=N_SCANS, n_pts=1200, seed=3)
    out = []
    for k in range(N_SCANS):
        s = Scan.from_points(locs[k], f"{k:03d}", odo[k])
        s.device = "cpu"
        s.set_reduction(25.0, 0)
        out.append(s)
    return out


def _pipe():
    # tests/test_torch_graph_pipeline.py's CLI flags (-d 50 -i 30
    # --epsICP 1e-6 -I 3 -D 50 --epsSLAM 0.1 --loopsize 8) but --cldist
    # 900: scan 16 finds scan 0, so the loop closes inside scan 17's step
    return GraphPipeline(
        icp_params=IcpParams(max_dist_match2=2500.0, max_iterations=30, epsilon=1e-6),
        lum_max_dist2=2500.0, lum_iterations=3, lum_epsilon=0.1, elch=True,
        cldist=900.0, loopsize=8, closure_lum_iterations=1, device="cpu",
    )


@pytest.fixture(scope="module")
def pipeline_runs():
    """The same run with no profiler and under a CPU profiler: (scans,
    pipe) of each, and the profiled run's timer ranges."""
    runs = []
    for profiled in (False, True):
        scans = _scans()
        pipe = _pipe()
        if profiled:
            with torch.profiler.profile(activities=CPU) as prof:
                pipe.run(scans)
        else:
            pipe.run(scans)
        runs.append((scans, pipe))
    return runs, _ranges(prof)


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _holder(r, outers):
    """The one range of ``outers`` that holds ``r``, else None."""
    held = [o for o in outers if _inside(r, o)]
    assert len(held) <= 1
    return held[0] if held else None


def test_one_scan_step_range_per_scan(pipeline_runs):
    _runs, ranges = pipeline_runs
    steps = _named(ranges, "scan_step_time")
    assert len(steps) == N_SCANS - 1
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))  # one after another, none nested


def test_each_match_lies_in_its_scan_step(pipeline_runs):
    _runs, ranges = pipeline_runs
    steps = _named(ranges, "scan_step_time")
    matches = _named(ranges, "matching_time")
    assert len(matches) == N_SCANS - 1
    assert [_holder(m, steps) for m in matches] == steps


def test_elch_lies_in_a_closure(pipeline_runs):
    (_off, (_scans_on, pipe)), ranges = pipeline_runs
    closures = _named(ranges, "closure_time")
    assert len(closures) == len(pipe.closures) > 0
    elch = _named(ranges, "elch_time")
    assert [_holder(e, closures) for e in elch] == closures
    # a closure runs inside the scan step that detected it
    steps = _named(ranges, "scan_step_time")
    for c, (_first, _last, upto) in zip(closures, pipe.closures):
        assert _holder(c, steps) == steps[upto - 1]


def test_a_relax_range_per_closure_and_for_the_final_relax(pipeline_runs):
    (_off, (_scans_on, pipe)), ranges = pipeline_runs
    closures = _named(ranges, "closure_time")
    relax = _named(ranges, "lum_relax_time")
    assert [_holder(r, closures) for r in relax] == closures + [None]
    for r in relax:
        kids = {k[0] for k in ranges if k is not r and _inside(k, r)}
        assert {"lum_cov_time", "lum_solve_time"} <= kids


def test_the_profiler_leaves_the_poses_bit_for_bit(pipeline_runs):
    ((off, p_off), (on, p_on)), _ranges_on = pipeline_runs
    assert p_off.closures == p_on.closures
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.transMat, b.transMat)
        assert len(a.frames) == len(b.frames)
        for (ta, ka), (tb, kb) in zip(a.frames, b.frames):
            np.testing.assert_array_equal(ta, tb)
            assert ka == kb


def test_chained_prepare_times_its_cell_list_spec():
    scans = _scans()[:3]
    reg = SequenceRegistration(
        params=IcpParams(max_dist_match2=2500.0, max_iterations=30, epsilon=1e-6),
        device="cpu", chained_min=512,
    )
    metrics.reset()
    with torch.profiler.profile(activities=CPU) as prof:
        reg.run(scans)
    assert reg._prep["cap"] >= reg.chained_min
    ranges = _ranges(prof)
    prepare = _named(ranges, "sequence_prepare_time")
    spec = _named(ranges, "cell_list_spec_time")
    assert len(prepare) == 1 and len(spec) == 1 and _inside(spec[0], prepare[0])
    assert metrics.timers["cell_list_spec_time"].count == 1
    metrics.reset()


def test_reduced_local_times_the_reduction_it_computes():
    s = _scans()[0]
    metrics.reset()
    first = s.reduced_local()
    again = s.reduced_local()
    timer = metrics.timers[REDUCTION]
    assert again is first
    assert timer.count == 1 and set(metrics.timers) == {REDUCTION}
    metrics.reset()
