#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu3dtk_torch``) on one NVIDIA
card: the quickest proof that the port builds and runs its main path on
the GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure ends the run with a nonzero
exit code and no result line):

1. device  — a CUDA card must be present; prints its name and power limit.
2. build   — builds every kernel of the path from csrc/ with nvcc.
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shapes (the first h468 match as the path gives it:
   reduced, padded to a multiple of 512 and masked; the raw 16384 x 16384
   scan pair; an awkward masked 70001-point model; the strict
   d² == max_dist2 boundary), with times.
4. slice   — ``torchslam`` (cli.slam6d.main) on the h468 ring corridor
   written as a uos directory (468 scans x 16384 points, -r 10 -O 1
   -d 50 -i 50 --epsICP 1e-6); the kernel's launch count must equal the
   ICP iterations; relative-pose error against ground truth is gated.
5. plain   — the first 8 scans through SequenceRegistration on the card
   and on the CPU (the plain path): same poses and iteration counts.
6. profile — the first h468 match (scan 1 against scan 0) once more under
   torch.profiler: kernel launches and device time per ICP iteration, the
   device's busy share, K1's share of the device time.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
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


def device_ms(fn, kernels, reps=10):
    """Device time per fn() call spent in the named kernels (ms), from a
    torch.profiler trace of ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if any(k in e.key for k in kernels)
    )
    check(us > 0, f"the profiler saw no device time in {kernels}")
    return us / reps / 1e3


def compare_nn(name, q, qm, m, mm, md2):
    """K1 against its plain version on the same CUDA tensors; returns
    (max |d2 diff|, wrapper ms, plain ms, the kernels' device ms, and the
    kernel's idx, d2, found).  Wrapper and plain are timed alike, with
    CUDA events around whole calls."""
    import torch

    from tpu3dtk_torch.ops import nn as nn_ops
    from tpu3dtk_torch.ops.nn_cuda import nn_brute_kernel

    k_idx, k_d2, k_found = nn_brute_kernel(q, qm, m, mm, md2)
    p_idx, p_d2, p_found = nn_ops.nn_brute(q, qm, m, mm, md2)
    torch.cuda.synchronize()
    agree = (k_idx == p_idx).double().mean().item()
    both = (k_d2 < nn_ops.BIG) & (p_d2 < nn_ops.BIG)
    err = (k_d2 - p_d2).abs()[both].max().item() if bool(both.any()) else 0.0
    mism = k_found != p_found
    ties_only = bool((k_d2[mism] == p_d2[mism]).all())
    check(agree >= 0.999, f"{name}: index agreement {agree} < 0.999")
    check(err <= 1e-2, f"{name}: chosen d2 differs by {err} > 1e-2")
    check(ties_only, f"{name}: found differs off exact ties")
    check(bool(torch.isfinite(k_d2).all()), f"{name}: non-finite d2")
    k_ms = cuda_ms(lambda: nn_brute_kernel(q, qm, m, mm, md2))
    p_ms = cuda_ms(lambda: nn_ops.nn_brute(q, qm, m, mm, md2))
    d_ms = device_ms(
        lambda: nn_brute_kernel(q, qm, m, mm, md2),
        ("nn_partial_kernel", "nn_merge_kernel"),
    )
    phase(
        3, "kernels",
        f"{name}: Q={q.shape[0]} M={m.shape[0]} agree={agree:.6f} "
        f"max|d2 diff|={err:.3e} found={int(k_found.sum())} "
        f"wrapper {k_ms:.4f} ms (kernels' own device time {d_ms:.4f} ms), "
        f"plain {p_ms:.4f} ms",
    )
    return err, k_ms, p_ms, d_ms, k_idx, k_d2, k_found


def rel_trans_err(mats, ref):
    """|translation error| of each consecutive relative pose (cm)."""
    import numpy as np

    out = []
    for k in range(1, len(mats)):
        a = np.linalg.inv(mats[k - 1]) @ mats[k]
        b = np.linalg.inv(ref[k - 1]) @ ref[k]
        out.append(float(np.linalg.norm(a[:3, 3] - b[:3, 3])))
    return np.asarray(out)


def profile_match(run):
    """One ICP match (``run()`` returns its IcpResult) under torch.profiler: per-iteration counts of the
    CUDA runtime's kernel launches, of the kernels and copies the card
    ran, and of device time; the busy share against the unprofiled
    match's wall time."""
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
    it = res.iterations
    check(res_p.iterations == it, "the profiled match ran another iteration count")
    ev = prof.events()
    api = sum(1 for e in ev if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name)
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    k1_us = sum(
        e.time_range.elapsed_us() for e in dev
        if "nn_partial_kernel" in e.name or "nn_merge_kernel" in e.name
    )
    check(busy_us > 0 and api > 0, "the profiler saw no launches or device time in the match")
    phase(
        6, "profile",
        f"first h468 match: {it} ICP iterations, {wall_ms / it:.4f} ms per "
        f"iteration unprofiled; per iteration: {api / it:.2f} kernel launches "
        f"(CUDA runtime calls), {(len(dev) - len(copies)) / it:.2f} kernels and "
        f"{len(copies) / it:.2f} copies/sets on the card, device time "
        f"{busy_us / it / 1e3:.4f} ms (K1 {k1_us / it / 1e3:.4f} ms, "
        f"{100 * k1_us / busy_us:.1f}% of it); device busy "
        f"{100 * busy_us / 1e3 / wall_ms:.1f}% of the unprofiled match",
    )


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
    from tpu3dtk_torch.ops import cuda_build, nn_cuda

    t0 = time.perf_counter()
    nn_cuda.load()
    build_s = time.perf_counter() - t0
    ptxas = " | ".join(
        ln.strip() for ln in cuda_build.build_logs.get("nn_brute", "").splitlines()
        if "registers" in ln or "spill" in ln
    )
    phase(2, "build", f"nn_brute built+loaded in {build_s:.2f} s; ptxas: {ptxas or 'cached'}")

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

    print(json.dumps({"kernels": [{
        "name": "nn_brute",
        "route": "cuda",
        "source": "tpu3dtk_torch/csrc/nn_brute.cu",
        "replaces": "tpu3dtk/ops/nn_pallas.py:732",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "device_ms": k_dev_ms,
    }]}))
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
