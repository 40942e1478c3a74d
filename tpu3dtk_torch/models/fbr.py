"""Feature-based registration ("fbr") — the port of
``tpu3dtk.models.fbr``: panorama features + RANSAC rigid estimation (ref
src/slam6d/fbr/: panorama -> OpenCV SIFT/ORB features (feature.cc) ->
matcher (feature_matcher.cc) -> RANSAC registration (registration.cc);
SURVEY §2.6).

Pipeline: project both scans to range panoramas (the port's numpy
``ops.panorama``), detect ORB/SIFT features on the normalized range
images (the port's ``ops.features``, on the device, in place of
OpenCV's), ratio-test the two nearest descriptors (``bf_knn_match``),
back-project matches to 3D via the panorama index map, then RANSAC over
3-point samples with the Horn closed form (numpy f64, the JAX package's
``default_rng(seed)`` draws); final pose refit on inliers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from ..ops import features
from ..ops.panorama import PanoramaParams, project_panorama

__all__ = ["FbrParams", "register_fbr", "estimate_rigid_ransac"]


@dataclasses.dataclass
class FbrParams:
    panorama: PanoramaParams = dataclasses.field(default_factory=PanoramaParams)
    detector: str = "orb"  # "orb" | "sift" (ref fbr feature.cc choices)
    n_features: int = 2000
    ratio: float = 0.8  # Lowe ratio test
    ransac_iters: int = 500
    inlier_dist: float = 25.0  # cm (ref registration dist threshold)
    min_inliers: int = 10


def _horn(m: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Closed-form rigid fit m ~ T d (numpy f64, small K)."""
    cm, cd = m.mean(0), d.mean(0)
    H = (d - cd).T @ (m - cm)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = cm - R @ cd
    return T


def estimate_rigid_ransac(
    model_pts: np.ndarray,
    data_pts: np.ndarray,
    iters: int = 500,
    inlier_dist: float = 25.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """RANSAC rigid transform from matched 3D pairs
    (ref fbr registration.cc: 3-point minimal samples).  Returns
    (T [4,4], inlier mask)."""
    rng = np.random.default_rng(seed)
    K = len(model_pts)
    if K < 3:
        raise ValueError("need >= 3 matches")
    best_inl = np.zeros(K, bool)
    for _ in range(iters):
        sel = rng.choice(K, 3, replace=False)
        try:
            T = _horn(model_pts[sel], data_pts[sel])
        except np.linalg.LinAlgError:
            continue
        res = np.linalg.norm(
            data_pts @ T[:3, :3].T + T[:3, 3] - model_pts, axis=1
        )
        inl = res < inlier_dist
        if inl.sum() > best_inl.sum():
            best_inl = inl
    if best_inl.sum() >= 3:
        T = _horn(model_pts[best_inl], data_pts[best_inl])
    else:
        T = np.eye(4)
    return T, best_inl


def register_fbr(
    model_local: np.ndarray,
    data_local: np.ndarray,
    params: FbrParams | None = None,
    device=None,
) -> dict:
    """Estimate the pose of `data` relative to `model` from panorama
    features.  Both inputs are local-frame [N, 3] clouds.  Detection and
    matching run on ``device`` (None: the first CUDA card).

    Returns {"T": [4,4] with model ≈ T·data, "n_matches", "n_inliers",
    "n_features": (model, data)}.
    """
    params = params or FbrParams()
    if device is None:
        from .. import default_device

        device = default_device()
    dev = torch.device(device)
    pano_m = project_panorama(model_local, params.panorama)
    pano_d = project_panorama(data_local, params.panorama)
    img_m = torch.as_tensor(pano_m.to_image(), device=dev)
    img_d = torch.as_tensor(pano_d.to_image(), device=dev)

    if params.detector == "sift":
        def detect(img):
            return features.sift_detect_and_compute(img, n_features=params.n_features)

        norm = "l2"
    else:
        def detect(img):
            return features.orb_detect_and_compute(img, n_features=params.n_features)

        norm = "hamming"
    kp_m, des_m = detect(img_m)
    kp_d, des_d = detect(img_d)
    nfeat = (len(kp_m), len(kp_d))
    if len(kp_m) < 3 or len(kp_d) < 3:
        return {"T": np.eye(4), "n_matches": 0, "n_inliers": 0, "n_features": nfeat}

    idx, dist = features.bf_knn_match(des_d, des_m, k=2, norm=norm)
    good = (dist[:, 0] < params.ratio * dist[:, 1]).cpu().numpy()
    if good.sum() < 3:
        return {"T": np.eye(4), "n_matches": int(good.sum()), "n_inliers": 0,
                "n_features": nfeat}

    uv_d = kp_d.pt.cpu().numpy().astype(np.float64)[good]
    uv_m = kp_m.pt.cpu().numpy().astype(np.float64)[idx[:, 0].cpu().numpy()[good]]
    idx_d, ok_d = pano_d.back_project(uv_d)
    idx_m, ok_m = pano_m.back_project(uv_m)
    ok = ok_d & ok_m
    if ok.sum() < 3:
        return {"T": np.eye(4), "n_matches": int(good.sum()), "n_inliers": 0,
                "n_features": nfeat}
    P_m = np.asarray(model_local)[idx_m[ok]]
    P_d = np.asarray(data_local)[idx_d[ok]]
    T, inl = estimate_rigid_ransac(
        P_m, P_d, params.ransac_iters, params.inlier_dist
    )
    out = {"T": T, "n_matches": int(ok.sum()), "n_inliers": int(inl.sum()), "n_features": nfeat}
    if inl.sum() < params.min_inliers:
        out["T"] = np.eye(4)
    return out
