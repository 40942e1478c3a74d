"""Bkd forest — dynamic (insert/remove) nearest-neighbour index, the port
of ``tpu3dtk.ops.bkd`` (the reference's ``BkdTree``,
include/slam6d/bkd.h:47-135: a forest of logarithmically-sized kd-trees;
inserts land in a small buffer, full levels merge upward — amortized
O(log n) rebuild instead of a full re-index per insert).

Each level is a device-resident point block searched by the exact brute
NN (``ops.nn``: kernel K1 on a card), not a pointer kd-tree; removal is a
tombstone mask (the reference swaps the point out of its leaf array —
same effect, bkd.h:67-75).  A block's model is prepared once
(``prepare_brute_model``) and kept until a removal changes its mask.
Queries scan the O(log n) levels and merge on the device, with one host
read a call: ``find_closest`` launches K1 once per block with alive
points (the buffer counts as one block).
"""

from __future__ import annotations

import numpy as np
import torch

from . import nn as nn_ops
from . import search

__all__ = ["BkdForest"]


class _Block:
    def __init__(self, pts: np.ndarray, device):
        self.pts_np = np.asarray(pts, np.float32).reshape(-1, 3)
        self.alive = np.ones(len(self.pts_np), bool)
        self.pts_dev = torch.as_tensor(self.pts_np, device=device)
        self._model = None  # BruteModel, prepared at the first query

    @property
    def model(self) -> nn_ops.BruteModel:
        if self._model is None:
            mask = torch.as_tensor(self.alive, device=self.pts_dev.device)
            self._model = nn_ops.prepare_brute_model(self.pts_dev, mask)
        return self._model

    def kill(self, hit: np.ndarray) -> None:
        self.alive[hit] = False
        self._model = None

    def n_alive(self) -> int:
        return int(self.alive.sum())


class BkdForest:
    """Insert/remove-able exact NN index over a forest of point blocks.

    ``buffer_size``: level-0 capacity; level k holds up to
    buffer_size * 2**k points (one block per level, bkd.h forest
    invariant).  All queries are exact over alive points.  ``device``:
    where the blocks live and the queries run (None: the first CUDA
    card).
    """

    def __init__(self, points=None, buffer_size: int = 4096, device=None):
        if device is None:
            from .. import default_device

            device = default_device()
        self.device = torch.device(device)
        self.buffer_size = int(buffer_size)
        self._buffer: list[np.ndarray] = []
        self._levels: dict[int, _Block] = {}
        if points is not None and len(points):
            self.insert(points)

    # -- dynamic interface (bkd.h insert/remove) -----------------------
    def insert(self, pts) -> None:
        pts = np.atleast_2d(np.asarray(pts, np.float32))
        self._buffer.extend(pts)
        if len(self._buffer) >= self.buffer_size:
            self._flush()

    def remove(self, pt, tol: float = 1e-6) -> int:
        """Tombstone every alive point equal to ``pt`` (within tol).
        Returns the number removed (bkd.h remove contract)."""
        pt = np.asarray(pt, np.float32)
        removed = 0
        kept = []
        for b in self._buffer:
            if np.all(np.abs(b - pt) <= tol):
                removed += 1
            else:
                kept.append(b)
        self._buffer = kept
        for blk in self._levels.values():
            hit = blk.alive & np.all(np.abs(blk.pts_np - pt) <= tol, axis=1)
            n = int(hit.sum())
            if n:
                blk.kill(hit)
                removed += n
        return removed

    def _flush(self) -> None:
        """Merge the buffer upward: find the first free level whose
        capacity holds the union of the buffer and all lower levels
        (mergeTreesLogarithmic, bkd.h:135)."""
        chunks = [np.asarray(self._buffer, np.float32).reshape(-1, 3)]
        self._buffer = []
        total = len(chunks[0])
        level = 0
        while True:
            blk = self._levels.pop(level, None)
            if blk is not None:
                alive = blk.pts_np[blk.alive]
                chunks.append(alive)
                total += len(alive)
            if total <= self.buffer_size * (2**level) and level not in self._levels:
                break
            level += 1
        merged = np.concatenate([c for c in chunks if len(c)], axis=0)
        if len(merged):
            self._levels[level] = _Block(merged, self.device)

    # -- queries (SearchTree interface) --------------------------------
    def _parts(self) -> list[_Block]:
        parts = list(self._levels.values())
        if self._buffer:
            parts.append(_Block(np.asarray(self._buffer), self.device))
        return [p for p in parts if p.n_alive()]

    def size(self) -> int:
        return len(self._buffer) + sum(b.n_alive() for b in self._levels.values())

    def collect_pts(self) -> np.ndarray:
        parts = [np.asarray(self._buffer).reshape(-1, 3)] if self._buffer else []
        parts += [b.pts_np[b.alive] for b in self._levels.values()]
        if not parts:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(parts, axis=0)

    def _queries(self, query, qmask):
        q = torch.as_tensor(query, dtype=torch.float32, device=self.device)
        qm = torch.as_tensor(qmask, dtype=torch.bool, device=self.device)
        return q.reshape(-1, 3), qm

    def find_closest(self, query, qmask, max_dist2):
        """Batched FindClosest over the forest: exact NN per block (one
        K1 call each on a card), merged by min distance on the device.
        Returns numpy (points [Q,3], d2 [Q] with inf where none, found
        [Q]) — the matched coordinates, since block-local indices are not
        stable across merges (the reference returns double*)."""
        q, qm = self._queries(query, qmask)
        Q = q.shape[0]
        md2 = float(np.float32(max_dist2))
        best_d2 = torch.full((Q,), nn_ops.BIG, dtype=torch.float32, device=self.device)
        best_pt = torch.zeros((Q, 3), dtype=torch.float32, device=self.device)
        found_any = torch.zeros(Q, dtype=torch.bool, device=self.device)
        for blk in self._parts():
            idx, d2, found = nn_ops.nn_brute_auto(q, qm, blk.model, None, md2)
            better = found & (d2 < best_d2)
            best_d2 = torch.where(better, d2, best_d2)
            best_pt = torch.where(better[:, None], blk.pts_dev[idx], best_pt)
            found_any |= better
        packed = torch.cat([best_pt, best_d2[:, None], found_any[:, None].float()], 1)
        out = packed.cpu().numpy()  # the one host read of the call
        found_np = out[:, 4] > 0
        return out[:, :3], np.where(found_np, out[:, 3], np.inf), found_np

    def fixed_range_search(self, query, qmask, max_dist2, K: int = 64):
        """All alive points within radius per query, merged across
        blocks on the device.  Returns numpy (points [Q, K, 3], d2 [Q, K],
        found [Q, K], count [Q]); exact iff every count < K."""
        q, qm = self._queries(query, qmask)
        Q = q.shape[0]
        md2 = float(np.float32(max_dist2))
        all_pts, all_d2, all_found = [], [], []
        for blk in self._parts():
            m = blk.model
            idx, d2, found, _cnt = search.fixed_range_search(
                q, qm, m.model, m.mmask, md2, K=min(K, m.model.shape[0]),
            )
            all_pts.append(blk.pts_dev[idx])
            all_d2.append(d2)
            all_found.append(found)
        if not all_pts:
            return (
                np.zeros((Q, K, 3), np.float32),
                np.full((Q, K), np.inf, np.float32),
                np.zeros((Q, K), bool),
                np.zeros(Q, np.int32),
            )
        pts = torch.cat(all_pts, dim=1)
        found = torch.cat(all_found, dim=1)
        d2m = torch.where(found, torch.cat(all_d2, dim=1), float("inf"))
        count = found.sum(1).to(torch.int32)
        order = torch.argsort(d2m, dim=1, stable=True)[:, :K]
        pts = torch.take_along_dim(pts, order[..., None], dim=1)
        d2m = torch.take_along_dim(d2m, order, dim=1)
        found = torch.take_along_dim(found, order, dim=1)
        if order.shape[1] < K:  # fewer alive points than K
            pad = K - order.shape[1]
            pts = torch.cat([pts, pts.new_zeros((Q, pad, 3))], 1)
            d2m = torch.cat([d2m, d2m.new_full((Q, pad), float("inf"))], 1)
            found = torch.cat([found, found.new_zeros((Q, pad))], 1)
        return (
            pts.cpu().numpy(), d2m.cpu().numpy(), found.cpu().numpy(),
            count.cpu().numpy(),
        )
