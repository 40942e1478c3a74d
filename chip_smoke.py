#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu3dtk_torch``) on one NVIDIA
card: the quickest proof that the port builds and runs its main path on
the GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure ends the run with a nonzero
exit code and no result line):

1. device  — a CUDA card must be present; prints its name and power limit.
2. build   — builds every kernel of the paths from csrc/ with nvcc, one
   nvcc per library, started together; prints registers, shared memory
   and spills.
3. kernels — K1 against its plain PyTorch version on the card, through a
   prepared model (as the ICP loop calls it) and through a bare
   (model, mask) call, at the main path's shapes (the first h468 match as
   the path gives it: reduced, padded to a multiple of 512 and masked;
   the raw 16384 x 16384 scan pair; an awkward masked 70001-point model;
   the strict d² == max_dist2 boundary), and against a ranking that
   prepares nothing (its own centre and mask term from the raw model),
   with wrapper times, the kernels' device time and the launches per call
   (at most 3 prepared).
4. slice   — ``torchslam`` (cli.slam6d.main) on the h468 ring corridor
   written as a uos directory (468 scans x 16384 points, -r 10 -O 1
   -d 50 -i 50 --epsICP 1e-6); the kernel's launch count must equal the
   ICP iterations; relative-pose error against ground truth is gated.
5. plain   — the first 8 scans through SequenceRegistration on the card
   and on the CPU (the plain path): same poses and iteration counts.
6. profile — the first h468 match (scan 1 against scan 0) once more under
   torch.profiler: kernel launches and device time per ICP iteration, the
   device's busy share, K1's share of the device time.
7. kernels B — K2 (the cell-list kernel) against its plain version at the
   bremen path's shape (scans 0 and 1 of the 13 x 1M-point city sequence
   reduced on the card, the first match's first NN call), on the table
   clamped to RB and on the unclamped one: identical rows and scores; the
   work items per call and their size R; the
   chain as the path runs it (RB=None: no clamp, no lane) and with RB
   against K1 at the same shape; the times the lane decision rests on; a
   forced overflow (RB=128) repaired by the lane; the lane's capacity
   exceeded; the strict boundary; times and the kernel's bound.
8. slice B — ``torchslam ... -n bremen.net`` on all 13 scans (-r 20 -O 1
   -d 150 -i 50 --epsICP 1e-4 -I 5 -D 150 --epsSLAM 0.5): K2's launch
   count must equal the chained ICP loop trips plus the chained LUM link
   calls, K1's the iterations of the matches redone by brute (none when no
   guard fired); not every match may be redone; ICP and LUM frames.
9. engines — the first 3 bremen scans through SequenceRegistration with
   the chained engine (K2) and with the brute engine (K1): same poses.
10. profile B — one chained bremen match under torch.profiler.

A line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.

The tuning sweeps behind the wrappers' constants (K1's blocks per SM,
K2's R and grid), the ranking loops' instruction count in the SASS and
the SM clock under load are not part of the smoke:
``python3 -m tpu3dtk_torch.tools.kernel_tuning`` prints them.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# h468 regime (bench.py:388-459, scripts/make_golden.py::synth_ring)
H468_SCANS = 468
N_PTS = 16384
SEED = 11
MAX_DIST = 50.0
# accuracy gate on the consecutive relative-pose translation error (cm):
# the JAX package gave 0.16-0.56 cm on scans 1-4 of this data (PERF.md)
GATE_MEDIAN_CM = 1.0

# bremen regime (bench.py:462-537, scripts/make_golden.py::synth_city)
CITY_SCANS = 13
CITY_PTS = 1_000_000
CITY_SEED = 23
CITY_DIST = 150.0
CITY_VOXEL = 20.0

# the card's published peaks (H100 SXM): f32 outside the tensor cores and
# device memory; and the instruction rate the kernels' source notes use (132 SMs x
# 4 schedulers x 32 lanes x 1.98 GHz over the instruction slots of one pair)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
LANE_INSTR_PER_S = 132 * 128 * 1.98e9
# instruction slots a pair of the ranking loops, as the kernels' source
# notes state them (tpu3dtk_torch.tools.kernel_tuning counts them in the SASS)
LOOP_SLOTS = {"nn_brute": 9.6, "nn_cell_list": 10.0}
PAIR_FLOPS = 8  # 3 subtracts, 3 multiplies, 2 adds
K1_KERNELS = ("nn_fill_kernel", "nn_rank_kernel", "nn_accept_kernel")
K2_KERNELS = ("cell_list_init_kernel", "cell_list_items_kernel", "cell_list_unpack_kernel")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(n, name, text):
    print(f"[phase {n} {name}] {text}", flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of fn() on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def burst_ms(fn, reps=20):
    """Milliseconds per fn() on the card over ``reps`` calls queued back
    to back between two CUDA events: the device time of calls that outlast
    their launch (the queue stays ahead of the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernels, reps=10):
    """Device time per fn() call spent in the named kernels (ms), from
    the device events of a torch.profiler trace of ``reps`` calls, and
    the CUDA runtime's kernel launches per call.  Where the trace holds
    none of the kernels, the time of ``reps`` back-to-back calls by CUDA
    events instead (equal to the kernels' time only where they outlast
    their launch; a line says so when that source is used)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == DeviceType.CUDA and any(k in e.name for k in kernels)
    )
    api = sum(
        1 for e in prof.events()
        if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name
    ) / reps
    if us > 0:
        return us / reps / 1e3, api
    print(f"[profiler] no device events for {kernels}: timing {reps} "
          "back-to-back calls with CUDA events instead", flush=True)
    return burst_ms(fn, reps), api


def nn_unprepared(q, qm, m, mm, md2):
    """Brute NN that shares nothing with ``prepare_brute_model``: its own
    masked mean, the mask as an added 0 / +inf, the gate written out."""
    import torch

    w = mm.to(torch.float32)[:, None]
    c = (m * w).sum(0) / torch.clamp(w.sum(), min=1.0)
    qc, mc = q - c, (m - c).T.contiguous()
    minf = torch.where(mm, 0.0, float("inf"))
    idx = torch.empty(q.shape[0], dtype=torch.int64, device=q.device)
    step = max(1, (1 << 24) // m.shape[0])
    for s in range(0, q.shape[0], step):
        dx, dy, dz = (qc[s:s + step, k:k + 1] - mc[k] for k in range(3))
        idx[s:s + step] = torch.argmin(dx * dx + dy * dy + dz * dz + minf, dim=1)
    e = q - m[idx]
    d2 = torch.where(mm[idx], e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2], 3.4e38)
    return idx, d2, qm & mm[idx] & (d2 < md2)


def compare_nn(name, q, qm, m, mm, md2):
    """K1 against its plain version on the same CUDA tensors, through a
    prepared model and through the bare call, and (the plain version ranks
    the prepared tensors the kernel reads too) against ``nn_unprepared``,
    which prepares nothing; returns (max |d2 diff|,
    prepared wrapper ms, plain ms, the kernels' device ms, and the
    kernel's idx, d2, found).  Wrappers and plain are timed alike, with
    CUDA events around whole calls, the two wrappers in turns."""
    import torch

    from tpu3dtk_torch.ops import nn as nn_ops
    from tpu3dtk_torch.ops.nn_cuda import nn_brute_kernel

    bm = nn_ops.prepare_brute_model(m, mm)
    p_idx, p_d2, p_found = nn_ops.nn_brute(q, qm, m, mm, md2)
    u_idx, u_d2, u_found = nn_unprepared(q, qm, m, mm, md2)
    err = 0.0
    for form, call in (
        ("prepared", lambda: nn_brute_kernel(q, qm, bm, None, md2)),
        ("bare", lambda: nn_brute_kernel(q, qm, m, mm, md2)),
    ):
        k_idx, k_d2, k_found = call()
        torch.cuda.synchronize()
        agree = (k_idx == p_idx).double().mean().item()
        both = (k_d2 < nn_ops.BIG) & (p_d2 < nn_ops.BIG)
        e = (k_d2 - p_d2).abs()[both].max().item() if bool(both.any()) else 0.0
        mism = k_found != p_found
        check(agree >= 0.999, f"{name} ({form}): index agreement {agree} < 0.999")
        check(e <= 1e-2, f"{name} ({form}): chosen d2 differs by {e} > 1e-2")
        check(bool((k_d2[mism] == p_d2[mism]).all()), f"{name} ({form}): found differs off exact ties")
        check(bool(torch.isfinite(k_d2).all()), f"{name} ({form}): non-finite d2")
        check(k_idx.dtype == torch.int64 and k_found.dtype == torch.bool, f"{name}: output types")
        u_agree = (k_idx == u_idx).double().mean().item()
        u_e = (k_d2 - u_d2).abs().max().item()
        u_mism = k_found != u_found
        check(u_agree >= 0.999, f"{name} ({form}): index agreement {u_agree} < 0.999 with the "
              "ranking that prepares nothing")
        check(u_e <= 1e-2, f"{name} ({form}): chosen d2 differs by {u_e} > 1e-2 from the "
              "ranking that prepares nothing")
        check(bool((k_d2[u_mism] == u_d2[u_mism]).all()),
              f"{name} ({form}): found differs off exact ties from the ranking that prepares nothing")
        err = max(err, e, u_e)
    prepared = lambda: nn_brute_kernel(q, qm, bm, None, md2)  # noqa: E731
    bare = lambda: nn_brute_kernel(q, qm, m, mm, md2)  # noqa: E731
    k_ms = [cuda_ms(prepared), 0.0]
    b_ms = [cuda_ms(bare), cuda_ms(bare)]
    k_ms[1] = cuda_ms(prepared)
    p_ms = cuda_ms(lambda: nn_ops.nn_brute(q, qm, m, mm, md2))
    prep_ms = cuda_ms(lambda: nn_ops.prepare_brute_model(m, mm))
    d_ms, k_api = device_ms(prepared, K1_KERNELS)
    r_ms, _ = device_ms(prepared, ("nn_rank_kernel",))
    _, b_api = device_ms(bare, K1_KERNELS)
    check(k_api <= 3, f"{name}: a prepared K1 call made {k_api} kernel launches, want <= 3")
    phase(
        3, "kernels",
        f"{name}: Q={q.shape[0]} M={m.shape[0]} agree={agree:.6f} "
        f"max|d2 diff|={err:.3e} found={int(k_found.sum())}; against the ranking that prepares "
        f"nothing agree={u_agree:.6f}; prepared: wrapper "
        f"{k_ms[0]:.4f} / {k_ms[1]:.4f} ms, {k_api:.1f} kernel launches a call, the kernels' "
        f"own device time {d_ms:.4f} ms (rank {r_ms:.4f} ms); bare: wrapper {b_ms[0]:.4f} / "
        f"{b_ms[1]:.4f} ms, {b_api:.1f} launches a call; prepare_brute_model alone "
        f"{prep_ms:.4f} ms; plain {p_ms:.4f} ms",
    )
    return err, min(k_ms), p_ms, d_ms, k_idx, k_d2, k_found


def rel_trans_err(mats, ref):
    """|translation error| of each consecutive relative pose (cm)."""
    import numpy as np

    out = []
    for k in range(1, len(mats)):
        a = np.linalg.inv(mats[k - 1]) @ mats[k]
        b = np.linalg.inv(ref[k - 1]) @ ref[k]
        out.append(float(np.linalg.norm(a[:3, 3] - b[:3, 3])))
    return np.asarray(out)


def nn_bound(pairs, nbytes, slots):
    """Least time (ms) the card could take: the larger of the f32
    operations over the f32 peak and the bytes (each input read once,
    each output written once) over the memory rate; which of the two;
    and the time at the instruction rate of the schedulers for ``slots`` instruction slots
    a pair (the kernel's inner loop), which is the tighter statement for
    this instruction mix."""
    ops_ms = pairs * PAIR_FLOPS / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, pairs * slots / LANE_INSTR_PER_S * 1e3


def profile_match(run, n=6, label="first h468 match", units=None,
                  kernel="K1", names=K1_KERNELS):
    """One ICP match (``run()`` returns its IcpResult) under
    torch.profiler: per-iteration counts of the CUDA runtime's kernel
    launches, of the kernels and copies the card ran, and of device
    time; the busy share against the unprofiled match's wall time.
    ``units(res)``: how many loop trips the match made (default: its
    iterations)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res_p = run()
        torch.cuda.synchronize()
    units = units or (lambda r: r.iterations)
    it = units(res)
    check(units(res_p) == it, "the profiled match ran another iteration count")
    ev = prof.events()
    api = sum(1 for e in ev if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name)
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    k1_us = sum(
        e.time_range.elapsed_us() for e in dev
        if any(k in e.name for k in names)
    )
    check(api > 0, "the profiler saw no kernel launches in the match")
    if busy_us == 0:
        phase(
            n, "profile",
            f"{label}: {it} ICP loop trips, {wall_ms / it:.4f} ms per iteration "
            f"unprofiled; per iteration: {api / it:.2f} kernel launches (CUDA "
            "runtime calls); device time not measured: the trace holds no "
            "device activity",
        )
        return
    phase(
        n, "profile",
        f"{label}: {it} ICP loop trips, {wall_ms / it:.4f} ms per "
        f"iteration unprofiled; per iteration: {api / it:.2f} kernel launches "
        f"(CUDA runtime calls), {(len(dev) - len(copies)) / it:.2f} kernels and "
        f"{len(copies) / it:.2f} copies/sets on the card, device time "
        f"{busy_us / it / 1e3:.4f} ms ({kernel} {k1_us / it / 1e3:.4f} ms, "
        f"{100 * k1_us / busy_us:.1f}% of it); device busy "
        f"{100 * busy_us / 1e3 / wall_ms:.1f}% of the unprofiled match",
    )


def ate_rmse(mats, ref):
    import numpy as np

    d = np.stack([m[:3, 3] for m in mats]) - np.stack([m[:3, 3] for m in ref])
    return float(np.sqrt((d**2).sum(1).mean()))


def bremen_phases(dev, params_city):
    """Phases 7-10: kernel K2 and the city-scale path.  Returns K2's entry
    for the kernels line."""
    import numpy as np
    import torch

    from tpu3dtk_torch import synth
    from tpu3dtk_torch.cli import slam6d
    from tpu3dtk_torch.core import math3d
    from tpu3dtk_torch.core.scan import Scan
    from tpu3dtk_torch.io import frames as frames_io
    from tpu3dtk_torch.io.frames import AlgoType
    from tpu3dtk_torch.models import graphslam as gs
    from tpu3dtk_torch.models import icp as icp_mod
    from tpu3dtk_torch.models import sequence as seq_mod
    from tpu3dtk_torch.ops import nn_cell_list as ncl
    from tpu3dtk_torch.ops import nn_cell_list_cuda, nn_cuda
    from tpu3dtk_torch.ops.nn_cell_list_cuda import cell_list_rows_kernel
    from tpu3dtk_torch.utils.metrics import metrics

    def cu(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    md2 = CITY_DIST**2
    t0 = time.perf_counter()
    locals_, true_mats, odo_mats = synth.synth_city(
        n_scans=CITY_SCANS, n_pts=CITY_PTS, seed=CITY_SEED
    )
    check(all(len(x) == CITY_PTS for x in locals_), "synth_city gave short scans")
    phase(7, "kernels B", f"synth_city {CITY_SCANS} x {CITY_PTS} pts generated in "
          f"{time.perf_counter() - t0:.1f} s")

    def reduced_scans(n):
        out = []
        for k in range(n):
            s = Scan.from_points(locals_[k], f"{k:03d}", odo_mats[k])
            s.device = "cuda"
            s.set_reduction(CITY_VOXEL, 1)
            s.reduced_local()
            out.append(s)
        return out

    # ---- phase 7: K2 at the path's shape ----------------------------------
    t0 = time.perf_counter()
    trio = reduced_scans(3)
    red_s = (time.perf_counter() - t0) / 3
    reg = seq_mod.SequenceRegistration(params=params_city, device="cuda")
    t0 = time.perf_counter()
    prep = reg._prepare(trio[:2])
    spec = prep["chain_spec"]
    check(spec is not None, "no cell-list spec at the bremen shape: the path would stay on brute")
    phase(
        7, "kernels B",
        f"reduction {red_s:.2f} s a scan; scans 0 and 1: "
        f"{int(prep['masks'][0].sum())} and {int(prep['masks'][1].sum())} reduced points, "
        f"padded to {prep['cap']}; spec sized on the host in {time.perf_counter() - t0:.2f} s: "
        f"RB={spec['RB']} chunk={spec['chunk']} perm={spec['perm']} dims={spec['dims']} "
        f"cap_over={spec['cap_over']}",
    )
    pair_mats = cu(np.stack(odo_mats[:2]).astype(np.float32))
    model, mmask = icp_mod._window(prep["locals"], prep["masks"], pair_mats, 0, 1, 1)
    model = model.contiguous()
    q = math3d.transform3(pair_mats[1], prep["locals"][1]).to(torch.float32).contiguous()
    qm = prep["masks"][1].contiguous()
    kw = dict(dims=spec["dims"], RB=spec["RB"], chunk=spec["chunk"],
              perm=tuple(spec["perm"]), cap_over=spec["cap_over"])
    clm, oob_m = ncl.build_cell_list_model(
        model, mmask, spec["origin"], CITY_DIST, dims=spec["dims"], RB=spec["RB"],
        perm=kw["perm"],
    )
    table, q_s, order, maxlen, oob_q = ncl.cell_list_plan_device(
        q, qm, clm, dims=spec["dims"], chunk=spec["chunk"], perm=kw["perm"]
    )
    check(int(oob_m) == 0 and int(oob_q) == 0, "points outside the grid box at the odometry poses")
    table_c = ncl.clamp_table(table, spec["RB"])
    T = spec["chunk"]
    W = table.shape[0]
    Mrows = clm.model_sorted.shape[0]
    n_over_chunks = int(((table[:, 3::3] + table[:, 4::3]).max(dim=1).values > spec["RB"]).sum())
    R = nn_cell_list_cuda.ITEM_ROWS
    k2_slots = LOOP_SLOTS["nn_cell_list"]
    k2_err = 0.0
    shapes = {}
    for tname, tab in (("clamped", table_c), ("unclamped", table)):
        k_rows, k_score = cell_list_rows_kernel(tab, q_s, clm.model_sorted, T)
        p_rows, p_score = ncl.cell_list_rows(tab, q_s, clm.model_sorted, T)
        torch.cuda.synchronize()
        check(torch.equal(k_rows, p_rows), f"K2 ({tname}): rows differ from the plain version")
        fin = torch.isfinite(p_score)
        check(torch.equal(torch.isfinite(k_score), fin), f"K2 ({tname}): candidate-less queries differ")
        e = (k_score[fin] - p_score[fin]).abs().max().item()
        check(e == 0.0, f"K2 ({tname}): scores differ from the plain version by {e}")
        k2_err = max(k2_err, e)
        fk = ncl.cell_list_post_device(k_rows, order, q, qm, clm, md2)[2]
        fp = ncl.cell_list_post_device(p_rows, order, q, qm, clm, md2)[2]
        check(torch.equal(fk, fp), f"K2 ({tname}): found differs from the plain version")
        prefix, totals = ncl.cell_list_work_items(tab, Mrows, R)
        # the item prefix the library's init kernel left in its scratch
        scratch = torch.empty(W * T + W + 2, dtype=torch.int64, device=dev)
        nn_cell_list_cuda._launch(
            tab, q_s, clm.model_sorted, T, R, 8, scratch, torch.empty_like(k_rows),
            torch.empty_like(k_score))
        check(torch.equal(scratch[W * T + 1:], prefix),
              f"K2 ({tname}): the kernel's item prefix differs from cell_list_work_items")
        shapes[tname] = dict(
            rows=k_rows, found=int(fk.sum()), cand=int(totals.sum()),
            longest=int(totals.max()), items=int(prefix[-1]),
        )

    # raw launches queued back to back outlast their launch, so two CUDA
    # events give the three kernels' device time whatever the profiler sees
    o_rows = torch.empty(W * T, dtype=torch.int32, device=dev)
    o_score = torch.empty(W * T, dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def raw_ms(tab):
        return burst_ms(lambda: nn_cell_list_cuda._launch(
            tab, q_s, clm.model_sorted, T, R, sms * nn_cell_list_cuda.BLOCKS_PER_SM,
            scratch, o_rows, o_score))

    dev_c = [raw_ms(table_c)]
    dev_u = [raw_ms(table) for _ in range(2)]
    dev_c.append(raw_ms(table_c))
    d_ms, du_ms = min(dev_c), min(dev_u)
    _, k2_api = device_ms(
        lambda: cell_list_rows_kernel(table, q_s, clm.model_sorted, T), K2_KERNELS)
    k_ms = cuda_ms(lambda: cell_list_rows_kernel(table_c, q_s, clm.model_sorted, T))
    ku_ms = cuda_ms(lambda: cell_list_rows_kernel(table, q_s, clm.model_sorted, T))
    p_ms = cuda_ms(lambda: ncl.cell_list_rows(table_c, q_s, clm.model_sorted, T), reps=3, warmup=1)
    pu_ms = cuda_ms(lambda: ncl.cell_list_rows(table, q_s, clm.model_sorted, T), reps=3, warmup=1)
    check(k2_api <= 3, f"a K2 call made {k2_api} kernel launches, want <= 3")
    sc, su = shapes["clamped"], shapes["unclamped"]
    pairs, u_pairs = sc["cand"] * T, su["cand"] * T
    nbytes = table.numel() * 4 + q_s.numel() * 4 + clm.model_sorted.numel() * 4 + 8 * W * T
    bound_ms, bound_by, instr_ms = nn_bound(pairs, nbytes, k2_slots)
    u_bound_ms, _, u_instr_ms = nn_bound(u_pairs, nbytes, k2_slots)
    phase(
        7, "kernels B",
        f"K2 at the first bremen NN call: Q={q.shape[0]} M={model.shape[0]} W={W} chunks of {T}; "
        f"clamped (RB {spec['RB']}, {n_over_chunks} chunks clamped) and unclamped table: rows "
        f"identical, max|score diff|={k2_err:.1e}, found identical ({sc['found']} / {su['found']}); "
        f"candidate rows per chunk: mean {sc['cand'] / W:.1f} / {su['cand'] / W:.1f}, max "
        f"{sc['longest']} / {su['longest']}, longest range {int(maxlen)}; work items of R={R} "
        f"rows: {sc['items']} / {su['items']} a call, grid {sms} x {nn_cell_list_cuda.BLOCKS_PER_SM} blocks",
    )
    phase(
        7, "kernels B",
        f"K2 device time (init + items + unpack, two CUDA events around 20 raw launches queued "
        f"back to back, in turns): clamped {dev_c[0]:.4f} / {dev_c[1]:.4f} ms, unclamped {dev_u[0]:.4f} / "
        f"{dev_u[1]:.4f} ms; {k2_api:.1f} kernel launches a wrapper call; wrapper {k_ms:.4f} ms "
        f"clamped, {ku_ms:.4f} ms unclamped, plain {p_ms:.4f} ms "
        f"clamped, {pu_ms:.4f} ms unclamped",
    )
    phase(
        7, "kernels B",
        f"K2 bound (clamped): {pairs:.4g} pairs x {PAIR_FLOPS} f32 operations over 67 TFLOP/s vs "
        f"{nbytes:.4g} bytes over 3.35 TB/s = {bound_ms:.5f} ms (bound by {bound_by}); candidate "
        f"bytes {sc['cand'] * 16 / PEAK_BYTES * 1e3:.5f} ms; at the instruction rate of its inner loop "
        f"({k2_slots:.2f} slots a pair, {LANE_INSTR_PER_S / k2_slots:.3g} pairs/s) {instr_ms:.5f} ms; "
        f"measured {pairs / d_ms / 1e9:.4g}e12 pairs/s; unclamped: {u_pairs:.4g} pairs, bound "
        f"{u_bound_ms:.5f} ms, instruction rate {u_instr_ms:.5f} ms, measured {u_pairs / du_ms / 1e9:.4g}e12 pairs/s",
    )

    # the chain as the path runs it (RB=None) and with RB, against K1: all exact
    b_idx, b_d2, b_found = nn_cuda.nn_brute_kernel(q, qm, model, mmask, md2)
    kw_path = dict(kw, RB=None)
    for cname, ckw in (("RB=None", kw_path), (f"RB={spec['RB']}", kw)):
        c_idx, c_d2, c_found, c_ovf, c_oob = ncl.nn_cell_list_chained(q, qm, clm, md2, **ckw)
        torch.cuda.synchronize()
        check(not bool(c_ovf) and int(c_oob) == 0, f"chain ({cname}): a guard fired at the odometry poses")
        check(torch.equal(c_found, b_found), f"chain ({cname}) vs K1: found differs")
        agree = (c_idx[c_found] == b_idx[c_found]).double().mean().item()
        d2_err = (c_d2[c_found] - b_d2[c_found]).abs().max().item()
        # K1 ranks on coordinates centred on the model mean, K2 on the raw
        # ones: a pair of candidates closer than that rounding (~1e-3 cm at
        # 10^4 cm extents) may swap; d2 is recomputed exactly for both
        check(agree >= 0.999, f"chain ({cname}) vs K1: index agreement {agree}")
        check(d2_err <= 0.5, f"chain ({cname}) vs K1: chosen d2 differs by {d2_err}")
        phase(7, "kernels B", f"chain ({cname}) vs K1 at {q.shape[0]} x {model.shape[0]}: found "
              f"identical ({int(c_found.sum())}), index agreement {agree:.6f}, max|d2 diff| {d2_err:.3e}")
    chain_ms = [cuda_ms(lambda: ncl.nn_cell_list_chained(q, qm, clm, md2, **kw_path), reps=10)]
    chain_rb_ms = [cuda_ms(lambda: ncl.nn_cell_list_chained(q, qm, clm, md2, **kw), reps=10)
                   for _ in range(2)]
    chain_ms.append(cuda_ms(lambda: ncl.nn_cell_list_chained(q, qm, clm, md2, **kw_path), reps=10))
    k1_ms = cuda_ms(lambda: nn_cuda.nn_brute_kernel(q, qm, model, mmask, md2), reps=5, warmup=1)
    lane_args = ncl.cell_list_post_device(shapes["clamped"]["rows"], order, q, qm, clm, md2)

    def lane():
        return ncl._overflow_lane(
            table, order, q, qm, *lane_args, clm, md2, RB=spec["RB"], chunk=T,
            cap_over=spec["cap_over"])

    lane_ms = cuda_ms(lane, reps=10)
    lane_dev_ms, lane_api = device_ms(lane, ("",))  # every device event of the call
    plan_ms = cuda_ms(lambda: ncl.cell_list_plan_device(
        q, qm, clm, dims=spec["dims"], chunk=T, perm=kw["perm"]), reps=10)
    post_ms = cuda_ms(lambda: ncl.cell_list_post_device(
        shapes["unclamped"]["rows"], order, q, qm, clm, md2), reps=10)
    phase(
        7, "kernels B",
        f"one chained NN call, in turns: RB=None (the path) {chain_ms[0]:.4f} / {chain_ms[1]:.4f} ms, "
        f"RB={spec['RB']} with the lane {chain_rb_ms[0]:.4f} / {chain_rb_ms[1]:.4f} ms; parts timed "
        f"alone: query plan {plan_ms:.4f} ms, K2 wrapper {ku_ms:.4f} ms, post {post_ms:.4f} ms, "
        f"overflow lane {lane_ms:.4f} ms ({lane_dev_ms:.4f} ms of it device time, {lane_api:.1f} "
        f"kernel launches); K1 brute at this shape {k1_ms:.4f} ms",
    )
    phase(
        7, "kernels B",
        f"lane decision: K2 on the unclamped table {du_ms:.4f} ms against K2 on the clamped table "
        f"{d_ms:.4f} ms + the lane's device time {lane_dev_ms:.4f} ms",
    )
    check(du_ms <= d_ms + lane_dev_ms,
          "unclamped K2 is slower than clamped K2 plus the lane: the path's RB=None route is the wrong one")

    # forced overflow: RB=128 clamps every range of a 30000-query subset;
    # the lane (K1) repairs them all
    sub = torch.randperm(q.shape[0], generator=torch.Generator().manual_seed(1))[:30000].to(dev)
    qs, qms = q[sub].contiguous(), qm[sub].contiguous()
    small = dict(kw, RB=128, cap_over=32768)
    clm_s, _ = ncl.build_cell_list_model(
        model, mmask, spec["origin"], CITY_DIST, dims=spec["dims"], RB=128, perm=kw["perm"])
    o_idx, o_d2, o_found, o_ovf, _ = ncl.nn_cell_list_chained(qs, qms, clm_s, md2, **small)
    check(not bool(o_ovf), "forced overflow: the lane's capacity was exceeded")
    check(torch.equal(o_found, b_found[sub]), "forced overflow: found differs from K1")
    o_agree = (o_idx[o_found] == b_idx[sub][o_found]).double().mean().item()
    check(o_agree >= 0.999, f"forced overflow: index agreement with K1 {o_agree}")
    _, _, _, cap_ovf, _ = ncl.nn_cell_list_chained(qs, qms, clm_s, md2, **dict(small, cap_over=4096))
    check(bool(cap_ovf), "lane capacity exceeded but the overflow guard stayed green")
    phase(7, "kernels B", f"forced overflow (RB=128, 30000 queries): repaired by the lane, "
          f"equal to K1 ({int(o_found.sum())} found); with cap_over=4096 the guard fires")

    # the strict boundary through the host-planned form
    nq = 5000
    qb = np.zeros((nq, 3), np.float32)
    qb[:, 0] = 40.0 * (np.arange(nq) % 70)
    qb[:, 1] = 40.0 * (np.arange(nq) // 70)
    mb = np.concatenate([qb + [10.0, 0.0, 0.0], qb + [0.0, 0.0, 60.0]]).astype(np.float32)
    for thr, expect in ((100.0, False), (100.01, True)):
        idx, d2, found = ncl.nn_cell_list(
            mb, np.ones(2 * nq, bool), qb, np.ones(nq, bool), thr, device=dev)
        check(bool((idx == np.arange(nq)).all()), "K2 boundary: wrong neighbour")
        check(bool((d2 == 100.0).all()), "K2 boundary: d2 != 100 exactly")
        check(bool((found == expect).all()), f"K2 boundary: found != {expect} at {thr}")
    phase(7, "kernels B", "boundary d2=100: not found at max_dist2=100.0, found at 100.01")

    # ---- phase 8: the bremen slice through the CLI ------------------------
    links = [(i, i + 1) for i in range(CITY_SCANS - 1)] + [(0, CITY_SCANS - 1)]
    with tempfile.TemporaryDirectory() as tmp:
        scan_dir = os.path.join(tmp, "scans")
        out_dir = os.path.join(tmp, "frames")
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        idents = synth.write_scan_dir(scan_dir, locals_, odo_mats)
        net = os.path.join(scan_dir, "bremen.net")
        synth.write_net_graph(net, CITY_SCANS, links)
        write_s = time.perf_counter() - t0
        metrics.reset()
        cell_list_rows_kernel.launches = 0
        nn_cuda.nn_brute_kernel.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = slam6d.main([
                scan_dir, "-f", "uos", "-r", str(CITY_VOXEL), "-O", "1", "-d", str(CITY_DIST),
                "-i", "50", "--epsICP", "1e-4", "-n", net, "-I", "5", "-D", str(CITY_DIST),
                "--epsSLAM", "0.5", "--frames-out", out_dir,
            ])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        k2_launches = cell_list_rows_kernel.launches
        k1_launches = nn_cuda.nn_brute_kernel.launches
        text = buf.getvalue()
        check(rc == 0, f"torchslam -n returned {rc}")
        frames = [frames_io.read_frames(frames_io.frames_path(out_dir, i)) for i in idents]
    cnt = {k: int(m.total) for k, m in metrics.counters.items()}
    tim = {k: m.total for k, m in metrics.timers.items()}
    iters = [int(v) for v in re.findall(r"^scan \d+: ITER (\d+)", text, re.M)]
    pairs_m = [int(v) for v in re.findall(r"pairs (\d+)$", text, re.M)]
    match_ms = float(re.search(r"Matching done in (\d+) milliseconds", text).group(1))
    check(len(iters) == CITY_SCANS - 1, f"{len(iters)} matches reported, want {CITY_SCANS - 1}")
    trips = cnt.get(icp_mod.CHAINED_TRIPS, 0)
    link_calls = cnt.get(gs.CHAINED_LINK_CALLS, 0)
    n_chain = cnt.get(seq_mod.CHAINED_MATCHES, 0)
    n_redone = cnt.get(seq_mod.CHAINED_REDONE, 0)
    check(k2_launches > 0, "the bremen path never launched K2")
    check(k2_launches == trips + link_calls,
          f"K2 launches {k2_launches} != ICP loop trips {trips} + LUM link calls {link_calls}")
    check(n_chain == CITY_SCANS - 1, f"{n_chain} matches went to the chained engine")
    check(n_redone < n_chain, "every chained match was redone by brute")
    # the path runs the chain without the overflow lane, so K1 runs only
    # where a fired guard had a match redone by the brute engine
    check((k1_launches > 0) == (n_redone > 0),
          f"K1 launches {k1_launches} on the bremen path with {n_redone} matches redone by brute")
    tags = [list(t) for _m, t in frames]
    lum_iters = tags[0].count(int(AlgoType.LUM))
    check(lum_iters >= 1 and link_calls % len(links) == 0 and link_calls >= lum_iters * len(links),
          f"{link_calls} LUM link calls for {lum_iters} LUM iterations of {len(links)} links")
    check(all(int(AlgoType.LUM) == t[-1] for t in tags), "the last frame of a scan is not LUM-tagged")
    check(all(int(AlgoType.ICP) in t for t in tags[1:]), "a registered scan has no ICP frame")
    mats = np.stack([m[-1] for m, _t in frames])
    check(bool(np.isfinite(mats).all()), "non-finite poses")
    icp_mats = np.stack([
        m[max(i for i, v in enumerate(t) if v != int(AlgoType.LUM))] for m, t in frames
    ])
    e = rel_trans_err(mats, true_mats)
    ei = rel_trans_err(icp_mats, true_mats)
    eo = rel_trans_err(np.stack(odo_mats), true_mats)
    phase(
        8, "slice B",
        f"{CITY_SCANS} scans x {CITY_PTS} pts written in {write_s:.1f} s; torchslam -n wall "
        f"{wall_s:.2f} s: read {tim.get('read_scan_time', 0.0):.2f} s, matching+LUM span "
        f"{match_ms / 1e3:.2f} s (LUM covariances {tim.get(gs.LUM_COV, 0.0):.2f} s, solve "
        f"{tim.get(gs.LUM_SOLVE, 0.0):.3f} s, {lum_iters} LUM iterations); {len(iters)} matches, "
        f"reported iterations {sum(iters)} (per match {iters}), median pairs "
        f"{int(np.median(pairs_m))}",
    )
    phase(
        8, "slice B",
        f"K2 launches {k2_launches} = {trips} chained ICP loop trips + {link_calls} chained LUM "
        f"link calls; matches redone by brute {n_redone} of {n_chain}; K1 launches "
        f"{k1_launches} (brute redos only: the path runs no overflow lane)",
    )
    phase(
        8, "slice B",
        f"consecutive relative-pose translation error (cm): after LUM median {np.median(e):.4f} "
        f"max {e.max():.4f}; after ICP median {np.median(ei):.4f} max {ei.max():.4f}; odometry "
        f"median {np.median(eo):.4f} max {eo.max():.4f}; ATE rmse after LUM "
        f"{ate_rmse(mats, true_mats):.2f} cm, after ICP {ate_rmse(icp_mats, true_mats):.2f} cm, "
        f"odometry {ate_rmse(odo_mats, true_mats):.2f} cm",
    )
    check(float(np.median(e)) < float(np.median(eo)), "registration is no better than odometry")

    # ---- phase 9: chained engine against brute engine ---------------------
    runs = {}
    for name, cmin in (("chained", 98304), ("brute", 10**12)):
        scans = []
        for s0 in trio:
            s = Scan.from_points(s0.xyz, s0.identifier, s0.transMatOrg)
            s.device = "cuda"
            s.set_reduction(CITY_VOXEL, 1)
            s._reduced_local = s0.reduced_local()
            scans.append(s)
        before = cell_list_rows_kernel.launches
        t0 = time.perf_counter()
        res = seq_mod.SequenceRegistration(
            params=params_city, device="cuda", chained_min=cmin).run(scans)
        torch.cuda.synchronize()
        runs[name] = (scans, res, time.perf_counter() - t0,
                      cell_list_rows_kernel.launches - before)
    (cs, cres, c_s, c_l), (bs, bres, b_s, b_l) = runs["chained"], runs["brute"]
    check(c_l > 0 and b_l == 0, f"engine choice: K2 launches {c_l} chained, {b_l} brute")
    dt = max(float(np.abs(a.transMat[:3, 3] - b.transMat[:3, 3]).max()) for a, b in zip(cs, bs))
    dr = max(float(np.abs(a.transMat[:3, :3] - b.transMat[:3, :3]).max()) for a, b in zip(cs, bs))
    di = max(abs(a["iterations"] - b["iterations"]) for a, b in zip(cres, bres))
    phase(
        9, "engines",
        f"3 bremen scans: chained (K2) {c_s:.2f} s incl. spec sizing vs brute (K1) {b_s:.2f} s; "
        f"iterations {[r['iterations'] for r in cres]} vs {[r['iterations'] for r in bres]}; "
        f"max pose diff {dt:.4f} cm / {dr:.2e} rot; max iteration diff {di}",
    )
    check(dt <= 0.01 and dr <= 1e-6, "chained and brute engine poses disagree")
    check(di <= 1, "chained and brute engine iteration counts disagree")

    # ---- phase 10: one chained bremen match, profiled ---------------------
    def chained_match():
        before = metrics.counters[icp_mod.CHAINED_TRIPS].total
        r = icp_mod.icp_pair_chained(
            model, mmask, prep["locals"][1], prep["masks"][1], pair_mats[1],
            max_dist_match2=md2, epsilon=params_city.epsilon,
            max_iterations=params_city.max_iterations, spec=spec,
        )
        chained_match.trips = int(metrics.counters[icp_mod.CHAINED_TRIPS].total - before)
        return r

    profile_match(
        chained_match, n=10, label="first bremen match (chained)",
        units=lambda r: chained_match.trips, kernel="K2", names=K2_KERNELS,
    )
    # the path gives K2 the unclamped table: the line's numbers are that
    # shape's; the clamped table's device time stays beside them
    return {
        "launches": k2_launches, "k1_launches": k1_launches, "max_abs_err": k2_err,
        "ms": ku_ms, "plain_ms": pu_ms, "device_ms": du_ms, "bound_ms": u_bound_ms,
        "bound_by": bound_by, "instr_bound_ms": u_instr_ms, "clamped_device_ms": d_ms,
    }


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    # ---- phase 1: device --------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device: the smoke runs on a card only")
    import tpu3dtk_torch

    check(
        os.path.dirname(os.path.abspath(tpu3dtk_torch.__file__))
        == os.path.join(HERE, "tpu3dtk_torch"),
        "tpu3dtk_torch must come from this checkout",
    )
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 (the default)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    phase(1, "device", f"{kind}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi_line, flush=True)

    # ---- phase 2: build ---------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    from tpu3dtk_torch.ops import cuda_build, nn_cell_list_cuda, nn_cuda

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per library, together
        for fut in [pool.submit(nn_cuda.load), pool.submit(nn_cell_list_cuda.load)]:
            fut.result()
    build_s = time.perf_counter() - t0
    for lib in ("nn_brute", "nn_cell_list"):
        ptxas = " | ".join(
            ln.strip() for ln in cuda_build.build_logs.get(lib, "").splitlines()
            if "registers" in ln or "spill" in ln
        )
        phase(2, "build", f"{lib}: ptxas: {ptxas or 'cached'}")
    phase(2, "build", f"nn_brute and nn_cell_list built+loaded together in {build_s:.2f} s")

    # ---- data (h468 regime) -----------------------------------------------
    from tpu3dtk_torch import synth

    t0 = time.perf_counter()
    locals_, true_mats, odo_mats = synth.synth_ring(
        n_scans=H468_SCANS, n_pts=N_PTS, seed=SEED
    )
    gen_s = time.perf_counter() - t0
    phase(3, "kernels", f"synth_ring {H468_SCANS} x {N_PTS} pts generated in {gen_s:.1f} s")

    # ---- phase 3: kernel vs plain on the card -----------------------------
    from tpu3dtk_torch.core import math3d
    from tpu3dtk_torch.core.scan import Scan
    from tpu3dtk_torch.models import icp as icp_mod
    from tpu3dtk_torch.models.icp import IcpParams
    from tpu3dtk_torch.models.sequence import SequenceRegistration

    def g(T, pts):
        return (pts.astype(np.float64) @ T[:3, :3].T + T[:3, 3]).astype(np.float32)

    def cu(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    md2 = MAX_DIST**2
    params = IcpParams(max_dist_match2=md2, max_iterations=50, epsilon=1e-6)

    # the first match's first NN call as the main path makes it: scans 0
    # and 1 reduced (-r 10 -O 1) on the card, uploaded padded and masked
    # by SequenceRegistration._prepare, the model window built by
    # icp._window, the query placed at scan 1's odometry pose
    pair = [Scan.from_points(locals_[k], f"{k:03d}", odo_mats[k]) for k in (0, 1)]
    for s in pair:
        s.device = "cuda"
        s.set_reduction(10.0, 1)
    prep = SequenceRegistration(params=params, device="cuda")._prepare(pair)
    pair_mats = cu(np.stack(odo_mats[:2]).astype(np.float32))
    m_red, mm_red = icp_mod._window(prep["locals"], prep["masks"], pair_mats, 0, 1, 1)
    q_red = math3d.transform3(pair_mats[1], prep["locals"][1]).contiguous()
    qm_red = prep["masks"][1].contiguous()
    phase(
        3, "kernels",
        f"first match as the path gives it: {int(qm_red.sum())} and "
        f"{int(mm_red.sum())} reduced points, padded to {q_red.shape[0]}",
    )
    err_r, k_ms, p_ms, k_dev_ms, *_ = compare_nn(
        "h468 first match, reduced + padded", q_red, qm_red,
        m_red.contiguous(), mm_red.contiguous(), md2,
    )

    k1_q, k1_m = q_red.shape[0], m_red.shape[0]
    k1_pairs = k1_q * k1_m
    # in: query + its mask, packed model, model + its mask, centre; out: idx, d2, found
    k1_bytes = 13 * k1_q + 29 * k1_m + 12 + 13 * k1_q
    k1_slots = LOOP_SLOTS["nn_brute"]
    k1_bound, k1_by, k1_instr = nn_bound(k1_pairs, k1_bytes, k1_slots)
    phase(
        3, "kernels",
        f"K1 bound at this shape: {k1_pairs:.4g} pairs x {PAIR_FLOPS} f32 operations over "
        f"67 TFLOP/s = {k1_bound:.5f} ms (bound by {k1_by}); at the instruction rate of its "
        f"inner loop ({k1_slots:.2f} slots a pair, {LANE_INSTR_PER_S / k1_slots:.3g} pairs/s) "
        f"{k1_instr:.5f} ms; measured {k1_pairs / k_dev_ms / 1e9:.4g}e12 pairs/s",
    )

    model0 = g(odo_mats[0], locals_[0])
    query1 = g(odo_mats[1], locals_[1])
    ones = torch.ones(N_PTS, dtype=torch.bool, device=dev)
    err_a, *_ = compare_nn(
        "h468 raw scan pair", cu(query1), ones, cu(model0), ones, md2
    )

    rng = np.random.default_rng(5)
    M = 70001
    m_aw = rng.uniform(-3000, 3000, (M, 3)).astype(np.float32)
    q_aw = (m_aw[rng.integers(0, M, 1000)] + rng.normal(0, 20, (1000, 3))).astype(np.float32)
    mm_aw = rng.uniform(size=M) > 0.1
    err_b, *_ = compare_nn(
        "awkward masked", cu(q_aw), torch.ones(1000, dtype=torch.bool, device=dev),
        cu(m_aw), cu(mm_aw), md2,
    )

    # boundary: each query has one model point at exactly d2 = 100 and a
    # distractor 60 cm away (integer coordinates: exact in f32)
    nq = 5000
    qb = np.zeros((nq, 3), np.float32)
    qb[:, 0] = 40.0 * (np.arange(nq) % 70)
    qb[:, 1] = 40.0 * (np.arange(nq) // 70)
    mb = np.concatenate([qb + [10.0, 0.0, 0.0], qb + [0.0, 0.0, 60.0]]).astype(np.float32)
    qbm = torch.ones(nq, dtype=torch.bool, device=dev)
    mbm = torch.ones(2 * nq, dtype=torch.bool, device=dev)
    for thr, expect in ((100.0, False), (100.01, True)):
        err_c, _, _, _, idx, d2, found = compare_nn(
            f"boundary d2=100 vs max_dist2={thr}", cu(qb), qbm, cu(mb), mbm, thr
        )
        check(bool((idx.cpu() == torch.arange(nq)).all()), "boundary: wrong neighbour")
        check(bool((d2 == 100.0).all()), "boundary: d2 != 100 exactly")
        check(bool((found == expect).all()), f"boundary: found != {expect} at {thr}")
    max_abs_err = max(err_r, err_a, err_b, err_c)

    # ---- phase 4: the slice through the CLI -------------------------------
    from tpu3dtk_torch.cli import slam6d
    from tpu3dtk_torch.io import frames as frames_io

    with tempfile.TemporaryDirectory() as tmp:
        scan_dir = os.path.join(tmp, "scans")
        out_dir = os.path.join(tmp, "frames")
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        idents = synth.write_scan_dir(scan_dir, locals_, odo_mats)
        write_s = time.perf_counter() - t0
        nn_cuda.nn_brute_kernel.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = slam6d.main([
                scan_dir, "-f", "uos", "-r", "10", "-O", "1", "-d", str(MAX_DIST),
                "-i", "50", "--epsICP", "1e-6", "--frames-out", out_dir,
            ])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = nn_cuda.nn_brute_kernel.launches
        text = buf.getvalue()
        check(rc == 0, f"torchslam returned {rc}")
        iters = [int(v) for v in re.findall(r"^scan \d+: ITER (\d+)", text, re.M)]
        pairs = [int(v) for v in re.findall(r"pairs (\d+)$", text, re.M)]
        match_ms = float(re.search(r"Matching done in (\d+) milliseconds", text).group(1))
        check(len(iters) == H468_SCANS - 1, f"{len(iters)} matches reported, want {H468_SCANS - 1}")
        total_iters = sum(iters)
        check(total_iters > 0, "no ICP iterations ran")
        check(
            launches == total_iters,
            f"kernel launches {launches} != ICP iterations {total_iters}",
        )
        mats = np.stack([
            frames_io.final_pose(frames_io.frames_path(out_dir, i)) for i in idents
        ])
        nframes = len(frames_io.read_frames(frames_io.frames_path(out_dir, idents[0]))[0])
    check(nframes == H468_SCANS - 1, f"{nframes} frames per scan, want {H468_SCANS - 1}")
    check(bool(np.isfinite(mats).all()), "non-finite poses")
    e = rel_trans_err(mats, true_mats)
    eo = rel_trans_err(np.stack(odo_mats), true_mats)
    med, med_o = float(np.median(e)), float(np.median(eo))
    phase(
        4, "slice",
        f"{H468_SCANS} scans written in {write_s:.1f} s; torchslam wall {wall_s:.2f} s, "
        f"matching {match_ms / 1e3:.2f} s: {H468_SCANS - 1} matches "
        f"({(H468_SCANS - 1) / (match_ms / 1e3):.2f}/s), {total_iters} ICP iterations "
        f"({total_iters / (match_ms / 1e3):.1f}/s), median pairs {int(np.median(pairs))}, "
        f"kernel launches {launches}",
    )
    phase(
        4, "slice",
        f"consecutive relative-pose translation error: median {med:.4f} cm, "
        f"max {e.max():.4f} cm; odometry median {med_o:.4f} cm, max {eo.max():.4f} cm",
    )
    check(med <= GATE_MEDIAN_CM, f"median relative-pose error {med} cm > {GATE_MEDIAN_CM}")
    check(med < med_o, "registration is no better than odometry")

    # ---- phase 5: the slice on the card against the plain path ------------
    runs = {}
    for name in ("cuda", "cpu"):
        scans = [
            Scan.from_points(locals_[k], f"{k:03d}", odo_mats[k]) for k in range(8)
        ]
        for s in scans:
            s.device = name
            s.set_reduction(10.0, 1)
        t0 = time.perf_counter()
        res = SequenceRegistration(params=params, device=name).run(scans)
        runs[name] = (scans, res, time.perf_counter() - t0)
    (cs, cres, c_s), (ps, pres, p_s) = runs["cuda"], runs["cpu"]
    dt = max(float(np.abs(a.transMat[:3, 3] - b.transMat[:3, 3]).max()) for a, b in zip(cs, ps))
    dr = max(float(np.abs(a.transMat[:3, :3] - b.transMat[:3, :3]).max()) for a, b in zip(cs, ps))
    di = max(abs(a["iterations"] - b["iterations"]) for a, b in zip(cres, pres))
    phase(
        5, "plain",
        f"8 scans: cuda {c_s:.2f} s vs cpu plain {p_s:.2f} s; max pose diff "
        f"{dt:.4f} cm / {dr:.2e} rot; max iteration diff {di}",
    )
    check(dt <= 0.5 and dr <= 1e-3, "card and plain path poses disagree")
    check(di <= 1, "card and plain path iteration counts disagree")

    # ---- phase 6: one match of the main path, profiled --------------------
    profile_match(
        lambda: icp_mod.icp_pair_seq(
            prep["locals"], prep["masks"], pair_mats, 0, 1, 1, pair_mats[1],
            md2, params.epsilon, 1, max_iterations=params.max_iterations,
            window_cap=1,
        )
    )

    k2 = bremen_phases(dev, IcpParams(
        max_dist_match2=CITY_DIST**2, max_iterations=50, epsilon=1e-4
    ))

    print(json.dumps({"kernels": [{
        "name": "nn_brute",
        "route": "cuda",
        "source": "tpu3dtk_torch/csrc/nn_brute.cu",
        "replaces": "tpu3dtk/ops/nn_pallas.py:732",
        "launches": launches,
        "launches_bremen": k2["k1_launches"],
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "device_ms": k_dev_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "instr_bound_ms": k1_instr,
        "library_ms": None,
    }, {
        "name": "nn_cell_list",
        "route": "cuda",
        "source": "tpu3dtk_torch/csrc/nn_cell_list.cu",
        "replaces": "tpu3dtk/ops/nn_pallas.py:224",
        "launches": k2["launches"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "device_ms": k2["device_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "instr_bound_ms": k2["instr_bound_ms"],
        "library_ms": None,
        "clamped_device_ms": k2["clamped_device_ms"],
    }]}))
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
