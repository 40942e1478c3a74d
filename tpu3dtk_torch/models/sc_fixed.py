"""Reduced-precision ICP — the port of ``tpu3dtk.models.sc_fixed`` (the
reference's ``sc_fixed`` module and ``icpFixpoint`` program,
src/sc_fixed/sc_ICP.cc, sc_fixed_math.h, src/slam6d/icpFixpoint.cc):
the reference validates ICP in fixed-point arithmetic for embedded/FPGA
targets, with a 10^-exp epsilon termination (icpFixpoint.cc:142
epsilonICPexp).

The datapath under test is the JAX package's: coordinates quantized to
bfloat16 around the model's centre, the NN ranking score
|m|² − 2·q·m from ONE bf16 product pass accumulated in f32 (the mode the
full-precision pipeline must avoid), the winner's distance recomputed in
f32 from the dequantized model for the accept gate, pair statistics in
f32.  It is plain torch and never reaches the exact brute kernel K1,
because it measures the precision loss K1 avoids.
``compare_fixed_float`` quantifies the pose error against the exact
pipeline (``icp.icp_pair``, K1 on a card), the role of the reference's
fixed-vs-double comparison harness.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import math3d
from ..utils.metrics import metrics
from . import minimizers as mz

__all__ = ["FixedIcpResult", "icp_pair_fixed", "compare_fixed_float"]

# metrics counters: iterations of the quantized ICP, and of the exact
# ICP that compare_fixed_float runs beside it (one K1 call each)
FIXED_ITERATIONS = "fixed_icp_iterations"
FLOAT_ITERATIONS = "fixed_compare_float_iterations"

_BIG = 3.4e38  # the JAX package's mask score and masked-winner distance


class FixedIcpResult(NamedTuple):
    T: torch.Tensor  # [4,4] f32 final pose of the target scan
    error: float  # final RMS error (f64 carry)
    iterations: int
    n_pairs: float  # pairs in the last iteration


class _QuantizedModel(NamedTuple):
    center: torch.Tensor  # [3] f32 masked centroid
    dequant: torch.Tensor  # [M,3] f32 bf16-quantized centred model, widened
    m2: torch.Tensor  # [M] f32 |m|² of the quantized model
    mmask: torch.Tensor  # [M] bool


def _quantize_model(model, mmask) -> _QuantizedModel:
    """The model centred once and quantized to bf16."""
    kept = torch.where(mmask[:, None], model, torch.zeros_like(model))
    center = kept.sum(0) / torch.clamp(mmask.sum(), min=1).to(torch.float32)
    dequant = (model - center).to(torch.bfloat16).to(torch.float32)
    return _QuantizedModel(center, dequant, (dequant * dequant).sum(1), mmask)


def _nn_bf16(query, qmask, qm: _QuantizedModel, max_dist2):
    """Single-pass bf16 NN ranking: the quantized datapath under test.
    bf16 operands widened to f32 multiply exactly (8-bit mantissas; they
    are exact in TF32 too), so the f32 product is the JAX package's
    ``preferred_element_type=float32`` dot up to the order of a 3-term
    sum.  Winner distances are recomputed in f32 for the accept gate
    (the reference's fixed-point compare also widens for the
    threshold).  Returns (idx [Q], found [Q], model_f32 [M,3])."""
    q = (query - qm.center).to(torch.bfloat16).to(torch.float32)
    score = qm.m2[None, :] - 2.0 * (q @ qm.dequant.T)
    score = torch.where(qm.mmask[None, :], score, torch.full_like(score, _BIG))
    idx = torch.argmin(score, dim=1)  # first index on ties, as jnp.argmin
    model_f32 = qm.dequant + qm.center
    diff = query - model_f32[idx]
    d2 = (diff * diff).sum(1)
    d2 = torch.where(qm.mmask[idx], d2, torch.full_like(d2, _BIG))
    found = qmask & (d2 < max_dist2)
    return idx, found, model_f32


def icp_pair_fixed(
    model, mmask, target_local, tmask, T0, max_dist_match2,
    *,
    max_iterations: int = 50,
    eps_exp: int = 3,
    minimizer: str = "quat",
) -> FixedIcpResult:
    """ICP with the quantized bf16 NN datapath and the fixed-point
    10^-eps_exp termination criterion (icpFixpoint.cc): stop when the
    f64 error moves less than 10^-eps_exp or there are 3 pairs or fewer.
    Tensors on one device; same contract as ``icp.icp_pair`` otherwise.
    One host read an iteration."""
    dev = model.device
    model = model.to(torch.float32)
    target_local = target_local.to(torch.float32)
    T = torch.as_tensor(T0, dtype=torch.float32, device=dev)
    eps = float(np.float32(10.0 ** (-eps_exp)))
    md2 = float(np.float32(max_dist_match2))
    qm = _quantize_model(model, mmask)
    align_fn = mz.get_minimizer(minimizer)
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)

    ret, prev, npairs = 0.0, np.inf, 0.0
    it = 0
    done = False
    while not done and it < max_iterations:
        tgt_g = math3d.transform3(T, target_local)
        idx, found, model_f32 = _nn_bf16(tgt_g, tmask, qm, md2)
        stats = mz.pair_stats(model_f32[idx], tgt_g, found)
        align, err = align_fn(stats)
        n, err_v = torch.stack([stats.n.double(), err.double()]).tolist()
        enough = n > 3
        T = (align if enough else eye4) @ T
        if enough:
            ret = err_v
        done = abs(ret - prev) < eps or not enough
        prev = ret
        npairs = n
        it += 1
    metrics.count(FIXED_ITERATIONS, it)
    return FixedIcpResult(T=T, error=ret, iterations=it, n_pairs=npairs)


def compare_fixed_float(
    model, target_local, T0, max_dist_match2, *, device=None, **kw
) -> dict:
    """Run the quantized and the exact pipeline on the same pair (numpy
    inputs, every point unmasked) on ``device`` (None: the first card)
    and report the pose disagreement (the icpFixpoint fixed-vs-double
    harness role).  ``kw`` goes to :func:`icp_pair_fixed`; the exact
    run takes epsilon 1e-7 and 50 iterations, as in the JAX package.
    Returns dict with both poses and deltas."""
    from .icp import icp_pair

    if device is None:
        from .. import default_device

        device = default_device()
    model = torch.as_tensor(np.asarray(model, np.float32), device=device)
    target = torch.as_tensor(np.asarray(target_local, np.float32), device=device)
    T0 = torch.as_tensor(np.asarray(T0, np.float32), device=device)
    mmask = torch.ones(len(model), dtype=torch.bool, device=device)
    tmask = torch.ones(len(target), dtype=torch.bool, device=device)
    rf = icp_pair_fixed(model, mmask, target, tmask, T0, max_dist_match2, **kw)
    rx = icp_pair(
        model, mmask, target, tmask, T0,
        max_dist_match2=max_dist_match2, epsilon=1e-7,
    )
    metrics.count(FLOAT_ITERATIONS, rx.iterations)
    Tf = rf.T.cpu().numpy().astype(np.float64)
    Tx = rx.T.cpu().numpy().astype(np.float64)
    return {
        "T_fixed": Tf,
        "T_float": Tx,
        "delta_translation_cm": float(np.linalg.norm(Tf[:3, 3] - Tx[:3, 3])),
        "delta_rotation_fro": float(np.linalg.norm(Tf[:3, :3] - Tx[:3, :3])),
        "iterations_fixed": int(rf.iterations),
        "iterations_float": int(rx.iterations),
    }
