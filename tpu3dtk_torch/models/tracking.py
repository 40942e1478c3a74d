"""Moving-object tracking — the port of ``tpu3dtk.models.tracking``, the
core of the reference's ``veloslam`` (src/veloslam/: clusters summarised
as boxes, trackermanager.cc; constant-velocity Kalman filters per
tracker, kalmanfilter.cc; measurement-to-tracker assignment on a cost
matrix, lap.cc Jonker-Volgenant, scipy's ``linear_sum_assignment`` here).

Per frame: segment the cloud into clusters (``models.segmentation``, the
k-NN graph on the device), summarise them as centroid + box, assign them
to the live tracks by the Hungarian method on predicted-position
distance, update the matched tracks' Kalman filters, spawn and retire
tracks.  A track with net motion is dynamic.  Host numpy, identical to
the JAX package's (which is numpy there too).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TrackerParams", "Track", "MultiObjectTracker"]


@dataclasses.dataclass
class TrackerParams:
    max_match_dist: float = 150.0  # gating distance (cm)
    process_noise: float = 25.0
    measurement_noise: float = 10.0
    max_misses: int = 3
    min_hits_dynamic: int = 3
    min_motion: float = 50.0  # net displacement to call a track dynamic (cm)
    cluster_threshold: float = 80.0
    cluster_min_size: int = 15


@dataclasses.dataclass
class Track:
    track_id: int
    x: np.ndarray  # [6] state: pos + vel
    P: np.ndarray  # [6, 6] covariance
    hits: int = 1
    misses: int = 0
    start_pos: np.ndarray | None = None
    bbox: tuple | None = None

    @property
    def pos(self) -> np.ndarray:
        return self.x[:3]

    @property
    def displacement(self) -> float:
        return float(np.linalg.norm(self.pos - self.start_pos))


class MultiObjectTracker:
    """Constant-velocity Kalman multi-object tracker (veloslam core)."""

    def __init__(self, params: TrackerParams | None = None, dt: float = 1.0, device=None):
        self.params = params or TrackerParams()
        self.dt = dt
        self.device = device  # where the clustering's k-NN runs (None: the first card)
        self.tracks: list[Track] = []
        self._next_id = 0
        # constant-velocity model
        self.F = np.eye(6)
        self.F[:3, 3:] = np.eye(3) * dt
        self.H = np.zeros((3, 6))
        self.H[:, :3] = np.eye(3)
        q = self.params.process_noise
        self.Q = np.diag([q, q, q, q * 4, q * 4, q * 4])
        r = self.params.measurement_noise
        self.R = np.eye(3) * r**2

    # -- measurement extraction ------------------------------------------
    def cluster_measurements(self, points: np.ndarray):
        """Cluster a frame's cloud into object candidates; returns
        (centroids [K,3], bboxes [K, 2, 3], labels)."""
        from .segmentation import FHParams, fh_segmentation

        labels = fh_segmentation(
            points,
            FHParams(
                k=6,
                threshold=self.params.cluster_threshold,
                min_size=self.params.cluster_min_size,
            ),
            device=self.device,
        )
        cents, boxes = [], []
        for l in np.unique(labels):
            sel = points[labels == l]
            if len(sel) < self.params.cluster_min_size:
                continue
            cents.append(sel.mean(0))
            boxes.append((sel.min(0), sel.max(0)))
        return np.asarray(cents).reshape(-1, 3), boxes, labels

    # -- filtering --------------------------------------------------------
    def step(self, measurements: np.ndarray, bboxes=None) -> list[Track]:
        """One frame: predict, associate, update, manage tracks."""
        from scipy.optimize import linear_sum_assignment

        # predict
        for t in self.tracks:
            t.x = self.F @ t.x
            t.P = self.F @ t.P @ self.F.T + self.Q

        K = len(measurements)
        T = len(self.tracks)
        matched_t = set()
        matched_m = set()
        if K and T:
            cost = np.linalg.norm(
                np.stack([t.pos for t in self.tracks])[:, None, :]
                - measurements[None, :, :],
                axis=-1,
            )
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if cost[r, c] > self.params.max_match_dist:
                    continue
                t = self.tracks[r]
                z = measurements[c]
                # Kalman update
                S = self.H @ t.P @ self.H.T + self.R
                Kk = t.P @ self.H.T @ np.linalg.inv(S)
                t.x = t.x + Kk @ (z - self.H @ t.x)
                t.P = (np.eye(6) - Kk @ self.H) @ t.P
                t.hits += 1
                t.misses = 0
                if bboxes is not None:
                    t.bbox = bboxes[c]
                matched_t.add(r)
                matched_m.add(c)
        # miss handling
        for i, t in enumerate(self.tracks):
            if i not in matched_t:
                t.misses += 1
        self.tracks = [
            t for t in self.tracks if t.misses <= self.params.max_misses
        ]
        # spawn new tracks
        for c in range(K):
            if c in matched_m:
                continue
            x = np.zeros(6)
            x[:3] = measurements[c]
            self.tracks.append(
                Track(
                    track_id=self._next_id,
                    x=x,
                    P=np.eye(6) * 100.0,
                    start_pos=measurements[c].copy(),
                    bbox=bboxes[c] if bboxes is not None else None,
                )
            )
            self._next_id += 1
        return self.tracks

    def dynamic_tracks(self) -> list[Track]:
        """Tracks classified as moving objects."""
        return [
            t
            for t in self.tracks
            if t.hits >= self.params.min_hits_dynamic
            and t.displacement >= self.params.min_motion
        ]

    def process_frame(self, points: np.ndarray) -> list[Track]:
        cents, boxes, _ = self.cluster_measurements(points)
        return self.step(cents, boxes)
