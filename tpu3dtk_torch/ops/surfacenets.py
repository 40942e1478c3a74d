"""Iso-surface extraction from voxel scalar fields — the port of
``tpu3dtk.ops.surfacenets`` (the mesh-output stage of the reference's
tsdf, vdb2mesh.cc marching cubes, and mesh, Poisson exportMesh, modules).

Naive surface nets: one vertex per sign-change cell at the centroid of
its edge crossings, one quad per sign-change edge joining the 4 cells
around it.  The JAX package runs this in numpy on the host; here it is
torch on the device the field lives on, so a TSDF volume of ~10^8 cells
never crosses to the host — only the vertices and faces do.  Cells are
numbered by ``torch.nonzero``, row-major like ``np.nonzero``, and the
vertex arithmetic is f64 as numpy's: faces come out identical and
vertices equal to the last bit on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["surface_nets"]

# the 8 cube corners, index bit order (x, y, z)
_OFFS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]
# the 12 cube edges as corner pairs
_EDGES = [(a, b) for a in range(8) for b in range(a + 1, 8) if bin(a ^ b).count("1") == 1]


def surface_nets(field, valid=None, origin=(0.0, 0.0, 0.0), voxel: float = 1.0, device=None):
    """Extract the zero iso-surface of ``field`` [X, Y, Z].

    ``field`` / ``valid`` (bool mask of trustworthy samples, e.g. TSDF
    weight > 0; cells touching an invalid sample are skipped): torch
    tensors (the work runs on their device) or numpy arrays (uploaded to
    ``device``; None: the package default, the first CUDA card).  Returns
    (vertices [V, 3] f64, triangles [T, 3] int32) as numpy arrays."""
    if isinstance(field, torch.Tensor):
        f, dev = field, field.device
    else:
        from .. import default_device

        dev = default_device() if device is None else torch.device(device)
        f = torch.as_tensor(np.asarray(field, np.float64), device=dev)
    X, Y, Z = f.shape
    if valid is None:
        valid = torch.ones(f.shape, dtype=torch.bool, device=dev)
    elif isinstance(valid, torch.Tensor):
        valid = valid.to(device=dev, dtype=torch.bool)
    else:
        valid = torch.as_tensor(np.asarray(valid, bool), device=dev)
    origin = torch.as_tensor(np.asarray(origin, np.float64), device=dev)

    neg = f < 0

    def corner(a, o):
        return a[o[0]: o[0] + X - 1, o[1]: o[1] + Y - 1, o[2]: o[2] + Z - 1]

    # sign change with every corner valid: any & ~all over the 8 corners
    any_neg = torch.zeros((X - 1, Y - 1, Z - 1), dtype=torch.bool, device=dev)
    all_neg = torch.ones_like(any_neg)
    all_valid = torch.ones_like(any_neg)
    for o in _OFFS:
        c = corner(neg, o)
        any_neg |= c
        all_neg &= c
        all_valid &= corner(valid, o)
    mixed = any_neg & ~all_neg & all_valid
    del any_neg, all_neg, all_valid
    cells = torch.nonzero(mixed)  # [C, 3], row-major as np.nonzero
    ci, cj, ck = cells.unbind(1)
    cell_idx = torch.full(mixed.shape, -1, dtype=torch.int64, device=dev)
    cell_idx[ci, cj, ck] = torch.arange(cells.shape[0], device=dev)

    # vertex = centroid of the cell's edge zero-crossings (f64, numpy's order)
    fvals = torch.stack([corner(f, o)[ci, cj, ck] for o in _OFFS], dim=-1).to(torch.float64)
    offs = torch.tensor(_OFFS, dtype=torch.float64, device=dev)
    acc = torch.zeros((cells.shape[0], 3), dtype=torch.float64, device=dev)
    cnt = torch.zeros(cells.shape[0], dtype=torch.float64, device=dev)
    for a, b in _EDGES:
        fa, fb = fvals[:, a], fvals[:, b]
        cross = (fa < 0) != (fb < 0)
        den = fa - fb
        t = torch.where(cross, fa / torch.where(den == 0, 1.0, den), 0.0)
        pa, pb = offs[a][None, :], offs[b][None, :]
        pt = pa + t[:, None] * (pb - pa)
        acc += torch.where(cross[:, None], pt, 0.0)
        cnt += cross
    centroid = acc / torch.clamp(cnt, min=1.0)[:, None]
    verts = (cells.to(torch.float64) + centroid + 0.0) * voxel + origin

    # faces: one quad per sign-change edge, across the 4 adjacent cells
    shape = torch.tensor(mixed.shape, device=dev)
    tris = []
    for axis in range(3):
        sl_a = [slice(0, X), slice(0, Y), slice(0, Z)]
        sl_b = list(sl_a)
        sl_a[axis] = slice(0, f.shape[axis] - 1)
        sl_b[axis] = slice(1, f.shape[axis])
        na = neg[tuple(sl_a)]
        e = torch.nonzero(na != neg[tuple(sl_b)])
        ax2, ax3 = [a for a in range(3) if a != axis]
        quads = []
        for d2 in (1, 0):
            for d3 in (1, 0):
                c = e.clone()
                c[:, ax2] -= d2
                c[:, ax3] -= d3
                quads.append(c)
        # consistent winding around the edge: (-1,-1), (0,-1), (0,0), (-1,0)
        quads = [quads[o] for o in (0, 2, 3, 1)]
        okv = torch.ones(e.shape[0], dtype=torch.bool, device=dev)
        vids = []
        for c in quads:
            okv &= ((c >= 0) & (c < shape)).all(1)
            cc = torch.minimum(torch.clamp(c, min=0), shape - 1)
            v = cell_idx[cc[:, 0], cc[:, 1], cc[:, 2]]
            okv &= v >= 0
            vids.append(v)
        q = torch.stack([v[okv] for v in vids], dim=1)
        flip = na[e[:, 0], e[:, 1], e[:, 2]][okv]  # inside at the low end: flip the winding
        q = torch.where(flip[:, None], q.flip(1), q)
        tris.append(q[:, [0, 1, 2]])
        tris.append(q[:, [0, 2, 3]])
    faces = torch.cat(tris, dim=0).to(torch.int32)
    return verts.cpu().numpy(), faces.cpu().numpy()
