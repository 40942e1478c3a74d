"""VeloSLAM — online SLAM with moving-object detection and tracking, the
port of ``tpu3dtk.models.veloslam`` (the reference's veloslam.cc:973 main
loop: per frame find the objects, classify them, by tracking too, remove
the moving points, match against a sliding window, update the trackers;
the reference classifies clusters with an SVM over hand-made features,
src/veloslam/svm.cc).

Per frame: FH segmentation (``models.segmentation``: the k-NN graph on
the device, the union-find on the host), per-cluster features and the
linear scorer on the host, the static points matched against the last
``sliding_window`` frames by ``models.icp.icp_pair`` — brute NN through
the CUDA kernel K1 on a card, the model prepared once a match, so K1
launches once per ICP iteration (counter ``veloslam_icp_iterations``) —
then the Kalman + Hungarian tracker (``models.tracking``).  The clouds go
to the device as they are: the JAX package pads them to a multiple of
``pad_multiple`` with masked points, which change nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import math3d
from ..core.scan import Scan
from ..io.frames import AlgoType
from ..ops.normals import sym3_eigenvalues
from ..utils.metrics import metrics
from . import icp as icp_mod
from .segmentation import FHParams, fh_segmentation
from .tracking import MultiObjectTracker, TrackerParams

__all__ = ["VeloParams", "VeloSlam", "classify_clusters", "cluster_features"]

ICP_ITERS = "veloslam_icp_iterations"  # metrics counter: window-ICP iterations (K1 calls)


@dataclasses.dataclass
class VeloParams:
    tracking: int = 2           # 0 off, 1 classify, 2 classify-by-tracking
    sliding_window: int = 3     # scans in the match window (ref sliding_window_size)
    max_dist_match2: float = 625.0
    max_iterations: int = 50
    epsilon: float = 1e-5
    cluster_threshold: float = 60.0
    cluster_min_size: int = 20
    # object-candidate gates (cm): the reference's vehicle/pedestrian
    # size priors (veloscan.cc cluster classification)
    min_extent: float = 30.0
    max_extent: float = 700.0
    max_height: float = 350.0


# default linear weights over the feature vector [extent_xz, height,
# log_count, planarity, linearity, sphericity, height_above_min]: a
# positive score = moving-object candidate; compact volumetric clusters
# score high, large extents and planar sheets (walls, ground) negative
_DEFAULT_W = np.array([-0.004, 0.0, 0.1, -3.0, 0.0, 3.0, 0.005])
_DEFAULT_B = 0.5


def cluster_features(pts: np.ndarray, frame_min_y: float) -> np.ndarray:
    """Per-cluster features (the svm.cc feature family).  The covariance
    is f64; its eigenvalues come from the closed-form solver in f32, as
    the JAX package's ``sym3_eigenvalues`` casts to f32 too."""
    lo = pts.min(0)
    hi = pts.max(0)
    extent_xz = float(np.hypot(hi[0] - lo[0], hi[2] - lo[2]))
    height = float(hi[1] - lo[1])
    c = pts - pts.mean(0)
    cov = c.T @ c / max(len(pts), 1)
    lam = np.sort(sym3_eigenvalues(torch.as_tensor(cov[None])).numpy()[0])  # ascending
    s = max(float(lam.sum()), 1e-9)
    planarity = float((lam[1] - lam[0]) / s)
    linearity = float((lam[2] - lam[1]) / s)
    sphericity = float(lam[0] / s) * 3.0
    return np.array([
        extent_xz, height, np.log(max(len(pts), 1)), planarity, linearity, sphericity,
        float(lo[1] - frame_min_y),
    ])


def classify_clusters(feats: np.ndarray, weights=None, bias: float | None = None) -> np.ndarray:
    """Linear moving-object scores for [K, 7] features; > 0 = candidate
    (the SVM decision role, svm.cc)."""
    w = _DEFAULT_W if weights is None else np.asarray(weights)
    b = _DEFAULT_B if bias is None else bias
    if len(feats) == 0:
        return np.zeros(0)
    return feats @ w + b


class VeloSlam:
    """Streaming per-frame SLAM + moving-object handling.  ``device``: where
    the k-NN graph and the window ICP run (None: the first CUDA card)."""

    def __init__(self, params: VeloParams | None = None, device=None):
        self.params = params or VeloParams()
        self.device = device
        self.tracker = MultiObjectTracker(
            TrackerParams(
                cluster_threshold=self.params.cluster_threshold,
                cluster_min_size=self.params.cluster_min_size,
            ),
            device=device,
        )
        self.window: list[np.ndarray] = []  # global static points
        self.trajectory: list[np.ndarray] = []
        self._dynamic_boxes: list[tuple] = []  # confirmed by tracking
        self.infos: list[dict] = []

    def _device(self) -> torch.device:
        if self.device is None:
            from .. import default_device

            self.device = default_device()
            self.tracker.device = self.device
        return torch.device(self.device)

    # -- per-frame pipeline --------------------------------------------
    def _segment_and_classify(self, pts_local: np.ndarray):
        p = self.params
        labels = fh_segmentation(
            pts_local,
            FHParams(k=6, threshold=p.cluster_threshold, min_size=p.cluster_min_size),
            device=self._device(),
        )
        frame_min_y = float(pts_local[:, 1].min())
        moving = np.zeros(len(pts_local), bool)
        clusters = []
        for lab in np.unique(labels):
            sel = labels == lab
            pts = pts_local[sel]
            if len(pts) < p.cluster_min_size:
                continue
            lo = pts.min(0)
            hi = pts.max(0)
            extent = float(np.hypot(hi[0] - lo[0], hi[2] - lo[2]))
            if not (p.min_extent <= extent <= p.max_extent):
                continue
            if hi[1] - lo[1] > p.max_height:
                continue
            clusters.append((sel, pts, cluster_features(pts, frame_min_y)))
        if clusters and p.tracking >= 1:
            scores = classify_clusters(np.stack([f for _, _, f in clusters]))
            for (sel, _, _), s in zip(clusters, scores):
                if s > 0:
                    moving[sel] = True
        return moving, clusters

    def process_scan(self, scan: Scan) -> dict:
        """One frame of the veloslam main loop.  Mutates the scan pose;
        returns the frame's info."""
        p = self.params
        dev = self._device()
        pts_local = np.asarray(scan.reduced_local())
        moving, clusters = self._segment_and_classify(pts_local)

        # classify-by-tracking: clusters inside a confirmed dynamic track's
        # gate are removed too (tracking==2 window logic)
        if p.tracking == 2 and self._dynamic_boxes:
            T_prev = scan.transMat
            for sel, pts, _ in clusters:
                c_g = np.asarray(math3d.transform3(T_prev, pts.mean(0)[None]))[0]
                for lo, hi in self._dynamic_boxes:
                    pad = 100.0
                    if np.all(c_g >= lo - pad) and np.all(c_g <= hi + pad):
                        moving[sel] = True
                        break

        static_local = pts_local[~moving]
        info = {
            "identifier": scan.identifier,
            "n_points": len(pts_local),
            "n_moving": int(moving.sum()),
            "n_clusters": len(clusters),
        }

        # sliding-window ICP (MatchTwoScan against the window metascan)
        if self.window:
            model = torch.as_tensor(np.concatenate(self.window), device=dev)
            tgt = torch.as_tensor(static_local.astype(np.float32), device=dev)
            res = icp_mod.icp_pair(
                model, torch.ones(model.shape[0], dtype=torch.bool, device=dev),
                tgt, torch.ones(tgt.shape[0], dtype=torch.bool, device=dev),
                torch.as_tensor(scan.transMat.astype(np.float32), device=dev),
                max_dist_match2=p.max_dist_match2,
                epsilon=p.epsilon,
                max_iterations=p.max_iterations,
            )
            metrics.count(ICP_ITERS, res.iterations)
            T = res.T.cpu().numpy().astype(np.float64)
            u, _, vt = np.linalg.svd(T[:3, :3])
            T[:3, :3] = u @ vt
            scan.set_pose(T, AlgoType.ICP)
            info["iterations"] = int(res.iterations)
            info["error"] = float(res.error)
        else:
            scan.add_frame(AlgoType.ICP)

        # tracker update with GLOBAL cluster centroids
        if p.tracking >= 1 and clusters:
            cents = np.stack([
                np.asarray(math3d.transform3(scan.transMat, pts.mean(0)[None]))[0]
                for _, pts, _ in clusters
            ])
            tracks = self.tracker.step(cents)
            self._dynamic_boxes = []
            for t in tracks:
                if (t.hits >= self.tracker.params.min_hits_dynamic
                        and t.displacement > self.tracker.params.min_motion):
                    self._dynamic_boxes.append((t.pos - 150.0, t.pos + 150.0))
            info["n_tracks"] = len(tracks)
            info["n_dynamic"] = len(self._dynamic_boxes)

        # keep the sliding window of the STATIC global points
        static_g = np.asarray(math3d.transform3(scan.transMat, static_local)).astype(np.float32)
        self.window.append(static_g)
        if len(self.window) > p.sliding_window:
            self.window.pop(0)
        self.trajectory.append(scan.transMat[:3, 3].copy())
        self.infos.append(info)
        return info

    def run(self, scans: list[Scan]) -> list[dict]:
        return [self.process_scan(s) for s in scans]
