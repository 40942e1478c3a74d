"""Tuning measurements behind the constants of the two CUDA kernels'
wrappers, on one NVIDIA card:

    python3 -m tpu3dtk_torch.tools.kernel_tuning

Prints, at the shapes the two main paths give the kernels (the first
h468 match, 468 x 16384-point ring; the first bremen NN call, 13 x
1M-point city):

- the instructions a pair of each ranking loop, counted in the SASS of
  the built libraries (the slot counts the kernels' source notes state);
- K1 (``ops/nn_cuda.py``): device time over the rank blocks per SM
  (``BLOCKS_PER_SM``);
- K2 (``ops/nn_cell_list_cuda.py``): device time over the work-item
  size R (``ITEM_ROWS``) and the persistent grid's blocks per SM
  (``BLOCKS_PER_SM``), on the table as the path plans it; R = 2^20 is
  one item a chunk, a chunk to a block;
- the SM clock and power draw while the card ranks.

Device times are two CUDA events around raw launches queued back to
back.  The wrappers take none of these values as arguments: a change is
an edit of the constant, made after reading this output.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import sys

import numpy as np
import torch

# (kernel, pairs of one trip of its ranking loop: 16 candidates x queries a thread)
RANK_LOOPS = {
    "nn_brute": ("nn_rank_kernel", 64),
    "nn_cell_list": ("cell_list_items_kernel", 32),
}


def burst_ms(fn, reps=20):
    """Milliseconds per fn() over ``reps`` calls queued back to back
    between two CUDA events."""
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


def sass_loop_slots(lib, kernel, pairs):
    """Instructions a pair of ``kernel``'s ranking loop in the SASS of the
    built library: the shortest loop (a backward branch and its target)
    that holds one FMNMX for each of the ``pairs`` of a trip.  None where
    cuobjdump is missing or its listing holds no such loop."""
    from ..ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    paths = sorted(glob.glob(str(cuda_build.BUILD_DIR / f"lib{lib}-*.so")), key=os.path.getmtime)
    if not os.path.isfile(tool) or not paths:
        return None
    proc = subprocess.run([tool, "-sass", paths[-1]], capture_output=True, text=True, timeout=120)
    best = None
    for fn in proc.stdout.split("Function : ")[1:]:
        if kernel not in fn.splitlines()[0]:
            continue
        ops = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", fn)]
        for addr, op, rest in ops:
            tgt = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if tgt is None or int(tgt.group(1), 16) >= addr:
                continue
            body = [o for a, o, _ in ops if int(tgt.group(1), 16) <= a <= addr]
            if sum(o.startswith("FMNMX") for o in body) == pairs and (best is None or len(body) < best):
                best = len(body)
    return None if best is None else best / pairs


def _reduced(locals_, odo_mats, n, voxel):
    from ..core.scan import Scan

    scans = [Scan.from_points(locals_[k], f"{k:03d}", odo_mats[k]) for k in range(n)]
    for s in scans:
        s.device = "cuda"
        s.set_reduction(voxel, 1)
    return scans


def k1_sweep(dev):
    from .. import synth
    from ..core import math3d
    from ..models import icp as icp_mod
    from ..models.icp import IcpParams
    from ..models.sequence import SequenceRegistration
    from ..ops import nn as nn_ops
    from ..ops import nn_cuda

    md2 = 50.0**2
    locals_, _true, odo = synth.synth_ring(n_scans=468, n_pts=16384, seed=11)
    params = IcpParams(max_dist_match2=md2, max_iterations=50, epsilon=1e-6)
    prep = SequenceRegistration(params=params, device="cuda")._prepare(
        _reduced(locals_, odo, 2, 10.0))
    mats = torch.as_tensor(np.stack(odo[:2]).astype(np.float32), device=dev)
    m, mm = icp_mod._window(prep["locals"], prep["masks"], mats, 0, 1, 1)
    q = math3d.transform3(mats[1], prep["locals"][1]).contiguous()
    qm = prep["masks"][1].contiguous()
    bm = nn_ops.prepare_brute_model(m.contiguous(), mm.contiguous())
    Q, M = q.shape[0], m.shape[0]
    out64 = torch.empty((2, Q), dtype=torch.int64, device=dev)
    d2 = torch.empty(Q, dtype=torch.float32, device=dev)
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = nn_cuda.nn_brute_kernel(q, qm, bm, None, md2)[0].clone()
    print(f"K1 at the first h468 match, {Q} x {M}: device ms of fill + rank + accept over "
          f"50 raw launches, by rank blocks per SM (the wrapper uses {nn_cuda.BLOCKS_PER_SM}):")
    for bps in (2, 3, 4, 6, 8, 12):
        S, chunk = nn_cuda._slices(Q, M, bps * sms)
        ms = burst_ms(lambda: nn_cuda._launch(q, qm, bm, S, chunk, md2, out64, d2, found), reps=50)
        assert torch.equal(out64[1], want), f"K1 at {bps} blocks an SM answers differently"
        print(f"  {bps}/SM (S={S} x {chunk}): {ms:.4f}", flush=True)


def k2_sweep(dev):
    from .. import synth
    from ..core import math3d
    from ..models import icp as icp_mod
    from ..models.icp import IcpParams
    from ..models.sequence import SequenceRegistration
    from ..ops import nn_cell_list as ncl
    from ..ops import nn_cell_list_cuda as k2

    dist = 150.0
    locals_, _true, odo = synth.synth_city(n_scans=13, n_pts=1_000_000, seed=23)
    params = IcpParams(max_dist_match2=dist**2, max_iterations=50, epsilon=1e-4)
    prep = SequenceRegistration(params=params, device="cuda")._prepare(
        _reduced(locals_, odo, 2, 20.0))
    spec = prep["chain_spec"]
    mats = torch.as_tensor(np.stack(odo[:2]).astype(np.float32), device=dev)
    m, mm = icp_mod._window(prep["locals"], prep["masks"], mats, 0, 1, 1)
    q = math3d.transform3(mats[1], prep["locals"][1]).to(torch.float32).contiguous()
    qm = prep["masks"][1].contiguous()
    perm = tuple(spec["perm"])
    clm, _oob = ncl.build_cell_list_model(
        m.contiguous(), mm, spec["origin"], dist, dims=spec["dims"], perm=perm)
    table, q_s, _order, _oob_q = ncl.cell_list_plan_device(
        q, qm, clm, dims=spec["dims"], chunk=spec["chunk"], perm=perm)
    T, W = spec["chunk"], table.shape[0]
    scratch = torch.empty(W * T + W + 2, dtype=torch.int64, device=dev)
    rows = torch.empty(W * T, dtype=torch.int32, device=dev)
    score = torch.empty(W * T, dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = k2.cell_list_rows_kernel(table, q_s, clm.model_sorted, T)[0].clone()

    def raw_ms(item_rows, bps):
        ms = burst_ms(lambda: k2._launch(
            table, q_s, clm.model_sorted, T, item_rows, sms * bps, scratch, rows, score))
        assert torch.equal(rows, want), f"K2 at R={item_rows} x {bps}/SM answers differently"
        return ms

    print(f"K2 at the first bremen NN call, W={W} chunks of {T}: device ms of init + items + "
          f"unpack over 20 raw launches (the wrapper uses R={k2.ITEM_ROWS} x "
          f"{k2.BLOCKS_PER_SM}/SM):")
    for item_rows in (256, 512, 1024, 2048, 4096, 1 << 20):
        for bps in (4, 8, 16):
            print(f"  R={item_rows} x {bps}/SM: {raw_ms(item_rows, bps):.4f}", flush=True)
    # the SM clock while the card ranks: launches queued, the clock read meanwhile
    for _ in range(3000):
        k2._launch(table, q_s, clm.model_sorted, T, k2.ITEM_ROWS, sms * k2.BLOCKS_PER_SM,
                   scratch, rows, score)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    torch.cuda.synchronize()
    print(f"SM clock, its maximum and the power draw under K2's load: {clocks}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_tuning: no CUDA device", file=sys.stderr)
        return 1
    from ..ops import nn_cell_list_cuda, nn_cuda

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip(), flush=True)
    nn_cuda.load()
    nn_cell_list_cuda.load()
    for lib, (kernel, pairs) in RANK_LOOPS.items():
        n = sass_loop_slots(lib, kernel, pairs)
        print(f"{lib}: ranking loop of {kernel}: " + (
            "not counted (no cuobjdump, or no such loop in its listing)" if n is None else
            f"{n * pairs:.0f} instructions for {pairs} pairs = {n:.2f} a pair"), flush=True)
    k1_sweep(dev)
    k2_sweep(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
