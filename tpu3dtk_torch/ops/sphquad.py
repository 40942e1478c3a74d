"""Spherical quadtree — angular search/reduction over directions, the
port's ``spherical_quadtree`` module (ref src/spherical_quadtree/
spherical_quadtree.cc + .py: recursive triangle subdivision of the unit
sphere with circumcircle-pruned cone search and angularly-uniform
reduction).

Design: the recursive QuadNode tree becomes a FLAT code array —
every point's direction is assigned a level-L triangle code by L rounds
of vectorized child tests (octahedron base, midpoint subdivision: the
same geometry as the reference, minus the pointers), then bucketed CSR-
style exactly like the cell hash.  Cone queries prune by per-bucket
circumcircle angle and finish with an exact dot-product test; reduction
keeps ``numpts`` samples per triangle at the level whose cap size
matches the requested angle.

The port's copy of ``tpu3dtk.ops.sphquad``, host numpy like it (no
module calls it; tests/test_torch_octree.py holds it against the JAX
package's).
"""

from __future__ import annotations

import numpy as np

__all__ = ["SphericalQuadtree"]


def _normalize(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


class SphericalQuadtree:
    """Flat-coded spherical quadtree over the directions of ``points``
    (seen from ``origin``)."""

    def __init__(self, points, origin=None, levels: int = 6):
        pts = np.asarray(points, np.float64)
        if origin is not None:
            pts = pts - np.asarray(origin, np.float64)
        self.levels = int(levels)
        self.dirs = _normalize(pts)
        N = len(self.dirs)

        # octahedron base: face = sign octant, vertices at signed axes,
        # orientation fixed so triple(v1, v2, v3) > 0
        sx = (self.dirs[:, 0] >= 0).astype(np.int64)
        sy = (self.dirs[:, 1] >= 0).astype(np.int64)
        sz = (self.dirs[:, 2] >= 0).astype(np.int64)
        octant = sx | (sy << 1) | (sz << 2)
        ex = np.zeros((N, 3))
        ex[:, 0] = np.where(sx > 0, 1.0, -1.0)
        ey = np.zeros((N, 3))
        ey[:, 1] = np.where(sy > 0, 1.0, -1.0)
        ez = np.zeros((N, 3))
        ez[:, 2] = np.where(sz > 0, 1.0, -1.0)
        # parity flip keeps the vertex triple positively oriented
        parity = (sx + sy + sz) % 2 == 0
        v1 = ex
        v2 = np.where(parity[:, None], ez, ey)
        v3 = np.where(parity[:, None], ey, ez)
        code = octant.copy()

        def triple(a, b, c):
            return np.einsum("ni,ni->n", np.cross(a, b), c)

        q = self.dirs
        for _ in range(self.levels):
            m12 = _normalize(v1 + v2)
            m23 = _normalize(v2 + v3)
            m31 = _normalize(v3 + v1)
            # child 0 = corner v1 (v1, m12, m31), 1 = corner v2,
            # 2 = corner v3, 3 = central (m12, m23, m31)
            in1 = (triple(v1, m12, q) >= 0) & (triple(m31, v1, q) >= 0)
            in2 = (triple(m12, v2, q) >= 0) & (triple(v2, m23, q) >= 0)
            child = np.where(in1, 0, np.where(in2, 1, 3))
            in3 = (triple(m23, v3, q) >= 0) & (triple(v3, m31, q) >= 0)
            child = np.where(in1 | in2, child, np.where(in3, 2, 3))
            code = code * 4 + child
            c0 = child[:, None] == 0
            c1 = child[:, None] == 1
            c2 = child[:, None] == 2
            nv1 = np.where(c0, v1, np.where(c1, m12, np.where(c2, m31, m12)))
            nv2 = np.where(c0, m12, np.where(c1, v2, np.where(c2, m23, m23)))
            nv3 = np.where(c0, m31, np.where(c1, m23, np.where(c2, v3, m31)))
            v1, v2, v3 = nv1, nv2, nv3

        self.codes = code
        self.order = np.argsort(code, kind="stable")
        codes_s = code[self.order]
        C = 8 * 4**self.levels
        self.bucket_start = np.searchsorted(codes_s, np.arange(C + 1))
        # per-bucket center + angular circumradius (from the contents)
        sums = np.zeros((C, 3))
        np.add.at(sums, codes_s, self.dirs[self.order])
        counts = np.maximum(
            self.bucket_start[1:] - self.bucket_start[:-1], 1
        )
        self.bucket_center = _normalize(sums / counts[:, None])
        cosang = np.einsum(
            "ni,ni->n", self.dirs[self.order], self.bucket_center[codes_s]
        )
        self.bucket_cos_r = np.ones(C)
        np.minimum.at(self.bucket_cos_r, codes_s, cosang)

    # -- queries --------------------------------------------------------
    def search(self, p, r: float) -> np.ndarray:
        """Indices of all points within ANGULAR distance r (radians) of
        direction p (QuadNode::search with circumcircle pruning)."""
        p = _normalize(np.asarray(p, np.float64)[None])[0]
        occupied = self.bucket_start[1:] > self.bucket_start[:-1]
        cos_c = self.bucket_center @ p
        ang_c = np.arccos(np.clip(cos_c, -1, 1))
        radius = np.arccos(np.clip(self.bucket_cos_r, -1, 1))
        cand = occupied & (ang_c <= r + radius)
        out = []
        cosr = np.cos(r)
        for b in np.nonzero(cand)[0]:
            sl = self.order[self.bucket_start[b] : self.bucket_start[b + 1]]
            keep = self.dirs[sl] @ p >= cosr
            out.append(sl[keep])
        if not out:
            return np.zeros(0, np.int64)
        return np.concatenate(out)

    def reduce(self, theta: float, numpts: int = 1, seed: int = 0):
        """Angularly-uniform subsample: at the subdivision level whose
        triangles are ~theta across, keep up to ``numpts`` indices per
        occupied triangle (QuadNode::reduce)."""
        # level-l triangles span ~ (pi/2) / 2^l radians
        lvl = int(np.clip(np.round(np.log2((np.pi / 2) / theta)), 0,
                          self.levels))
        shift = 2 * (self.levels - lvl)
        coarse = self.codes >> shift
        rng = np.random.default_rng(seed)
        out = []
        order = np.argsort(coarse, kind="stable")
        cs = coarse[order]
        starts = np.searchsorted(cs, np.arange(8 * 4**lvl + 1))
        for b in range(8 * 4**lvl):
            sl = order[starts[b] : starts[b + 1]]
            if len(sl) == 0:
                continue
            if len(sl) <= numpts:
                out.append(sl)
            else:
                out.append(rng.choice(sl, numpts, replace=False))
        return np.concatenate(out) if out else np.zeros(0, np.int64)
