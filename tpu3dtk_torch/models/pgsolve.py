"""Pose-graph solver for the LUM normal equations G·X = B — the port of
``tpu3dtk.models.pgsolve`` (the reference assembles a sparse 6n x 6n SPD
matrix and calls CXSparse's ``cs_cholsol``, src/slam6d/graphSlam6D.cc:
345-366).

G is never materialized: it is defined by its 6x6 link blocks

    G[a,a] += C_l,  G[b,b] += C_l,  G[a,b] -= C_l,  G[b,a] -= C_l

for every link l = (a, b) (scan 0 fixed, so variable = scan - 1 and
index -1 is dropped; FillGB3D, src/slam6d/lum6Deuler.cc:265-303), and
the matvec is O(L) scatter-adds over the link blocks:

    (G x)_a = Σ_{l: a∈l} C_l x_a − Σ_{l=(a,b)} C_l x_b .

:func:`solve_block_cg` is block-Jacobi-preconditioned conjugate gradients
in f64 torch on the device of its tensors: the host LUM path's solver
above ``LumParams.dense_solver_max_scans`` scans (on CPU tensors) and the
on-device LUM's solver where the dense system does not fit on the card.
The JAX package has a numpy host copy (``solve_block_cg``) and an f32
device copy to a 1e-6 residual (``solve_block_cg_jax``); the port keeps
one, in f64 to a 1e-12 residual on either device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["link_rhs", "solve_block_cg"]


def _link_vars(links, n: int, dev):
    """Per link: the clamped variable indices of both ends (scan - 1)
    and f64 weights [L,1] that are 0 where an end is the fixed scan 0."""
    lk = torch.as_tensor(np.asarray(links, np.int64).reshape(-1, 2), device=dev)
    a, b = lk[:, 0] - 1, lk[:, 1] - 1
    wa, wb = (a >= 0).double()[:, None], (b >= 0).double()[:, None]
    return a.clamp(0, n - 1), b.clamp(0, n - 1), wa, wb


def link_rhs(links, CD: torch.Tensor, n: int) -> torch.Tensor:
    """B [n,6] f64 on the device of ``CD`` [L,6]: B[a] += CD_l,
    B[b] -= CD_l for every link l = (a, b) (FillGB3D's right-hand side)."""
    ac, bc, wa, wb = _link_vars(links, n, CD.device)
    CD = CD.double()
    B = torch.zeros((n, 6), dtype=torch.float64, device=CD.device)
    B.index_add_(0, ac, CD * wa)
    B.index_add_(0, bc, -CD * wb)
    return B


def solve_block_cg(links, C, B, n: int, tol: float = 1e-12,
                   maxiter: int | None = None, device=None):
    """Block-Jacobi-preconditioned CG for G X = B in f64 torch on the
    device of ``C``.

    links [L,2] scan indices (host array or tensor); C [L,6,6], B [n,6]
    (n = n_scans - 1) tensors (numpy arrays are uploaded to ``device``;
    None: the package default, the first CUDA card).  The matvec
    scatter-adds the link blocks (``index_add_``); each iteration reads
    back one packed pair of scalars (the curvature pᵀAp and the residual
    norm) for the stop tests.  Returns (X [n,6] f64 tensor, iterations
    run); X matches the dense solve to ~sqrt(cond)·tol."""
    if not isinstance(C, torch.Tensor):
        from .graphslam import _resolve_device

        dev = _resolve_device(device)
        C, B = torch.as_tensor(np.asarray(C), device=dev), torch.as_tensor(np.asarray(B), device=dev)
    dev = C.device
    C = C.to(torch.float64)
    B = B.to(torch.float64, copy=False).to(dev)
    ac, bc, wa, wb = _link_vars(links, n, dev)

    def matvec(x):
        Cd = torch.einsum("lij,lj->li", C, x[ac] * wa - x[bc] * wb)
        y = torch.zeros_like(x)
        y.index_add_(0, ac, Cd * wa)
        y.index_add_(0, bc, -Cd * wb)
        return y

    D = torch.zeros((n, 6, 6), dtype=C.dtype, device=dev)
    D.index_add_(0, ac, C * wa[:, :, None])
    D.index_add_(0, bc, C * wb[:, :, None])
    # regularize rank-deficient diagonal blocks (isolated scans)
    tr = torch.diagonal(D, dim1=1, dim2=2).sum(-1)
    eye6 = torch.eye(6, dtype=C.dtype, device=dev)
    Dinv = torch.linalg.inv(D + torch.clamp(tr, min=1.0)[:, None, None] * 1e-14 * eye6)

    def precond(r):
        return torch.einsum("nij,nj->ni", Dinv, r)

    x = torch.zeros_like(B)
    r = B.clone()
    z = precond(r)
    p = z.clone()
    rz = (r * z).sum()
    bnorm = float(torch.linalg.norm(B)) or 1.0
    it = 0
    for it in range(1, (maxiter or max(200, 12 * n)) + 1):
        Ap = matvec(p)
        pAp = (p * Ap).sum()
        alpha = rz / torch.where(pAp > 0, pAp, 1.0)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        pAp_v, rnorm = torch.stack([pAp, torch.linalg.norm(r_new)]).tolist()
        if pAp_v <= 0:
            break
        x, r = x_new, r_new
        if rnorm < tol * bnorm:
            break
        z = precond(r)
        rz_new = (r * z).sum()
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, it
