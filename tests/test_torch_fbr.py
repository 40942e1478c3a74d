"""The port's feature detectors, matcher (``ops.features``) and
feature-based registration (``models.fbr``) against OpenCV, a numpy
brute force and the JAX package, on the CPU (``device="cpu"``).

Bounds: FAST-9 corners (threshold 20, non-maximum suppression) equal to
``cv2.FastFeatureDetector``'s, with equal scores; ORB and SIFT each match
at least 40 keypoints correctly (within 2 px) across a 30° rotation and
a 1.2x scale of a seeded image (OpenCV 5.0's ORB and SIFT at 1000
features match 211 and 52 there); the port's ORB descriptors on its own
keypoints equal to ``cv2.ORB_create().compute``'s, up to 0.5% of the bits
(the levels above 0 resize the image with other rounding); ``bf_knn_match``
identical to a numpy brute force (indices and distances); RANSAC
identical to the JAX package's on the same matches; ``register_fbr``
with ORB on tests/test_fbr.py's scene, and with SIFT on that scene with
12 boxes added (on the bare scene the JAX package's SIFT finds 7 matches,
below ``min_inliers``, and returns the identity), yaw within 0.03 rad of
the truth and of the JAX package's result.
"""

import cv2
import numpy as np
import pytest
import torch
from scipy import ndimage

from tests.conftest import make_room_cloud
from tpu3dtk.core import math3d
from tpu3dtk.models import fbr as jfbr
from tpu3dtk.ops.panorama import PanoramaParams as JPanoramaParams
from tpu3dtk_torch import interop
from tpu3dtk_torch.models import fbr as tfbr
from tpu3dtk_torch.ops import features as ft


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene_image(seed=1, H=300, W=400):
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W))
    for _ in range(60):
        y, x = rng.integers(0, H), rng.integers(0, W)
        h, w = rng.integers(5, 60, 2)
        img[y:y + h, x:x + w] += rng.uniform(-80, 80)
    img = ndimage.gaussian_filter(img, 1.0) + rng.normal(0, 2, img.shape)
    return np.clip(img - img.min(), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [1, 2])
def test_fast_corners_equal_opencv(seed):
    img = _scene_image(seed)
    xy, score = ft.fast_corners(img, 20, device="cpu")
    kps = cv2.FastFeatureDetector_create(threshold=20, nonmaxSuppression=True).detect(img)
    ref = {(int(round(k.pt[0])), int(round(k.pt[1]))): k.response for k in kps}
    got = dict(zip(map(tuple, xy.numpy().tolist()), score.numpy().tolist()))
    assert len(ref) > 50 and got == ref


def _warp(img, deg=30.0, s=1.2):
    """img rotated by ``deg`` and scaled by ``s`` about its centre; returns
    (warped, A, c) with q = A (p − c) + c in (x, y)."""
    H, W = img.shape
    a = np.deg2rad(deg)
    A = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]) * s
    c = np.array([W / 2, H / 2])
    Ai = np.linalg.inv(A)
    M = np.array([[Ai[1, 1], Ai[1, 0]], [Ai[0, 1], Ai[0, 0]]])
    off = c[::-1] - M @ c[::-1]
    out = ndimage.affine_transform(img.astype(float), M, offset=off, order=1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8), A, c


@pytest.mark.parametrize("kind", ["orb", "sift"])
def test_matches_survive_rotation_and_scale(kind):
    img = _scene_image(1)
    img2, A, c = _warp(img)
    if kind == "orb":
        k1, d1 = ft.orb_detect_and_compute(img, 1000, device="cpu")
        k2, d2 = ft.orb_detect_and_compute(img2, 1000, device="cpu")
        assert d1.dtype == torch.uint8 and d1.shape[1] == 32
        norm = "hamming"
    else:
        k1, d1 = ft.sift_detect_and_compute(img, 1000, device="cpu")
        k2, d2 = ft.sift_detect_and_compute(img2, 1000, device="cpu")
        assert d1.shape[1] == 128 and bool((d1 == torch.round(d1)).all())
        norm = "l2"
    idx, dist = ft.bf_knn_match(d1, d2, 2, norm)
    good = (dist[:, 0] < 0.8 * dist[:, 1]).numpy()
    p1 = k1.pt.numpy()[good]
    p2 = k2.pt.numpy()[idx[:, 0].numpy()[good]]
    err = np.linalg.norm((p1 - c) @ A.T + c - p2, axis=1)
    assert (err <= 2.0).sum() >= 40, ((err <= 2.0).sum(), len(err))


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("turned", [False, True])
def test_orb_descriptors_equal_opencv(seed, turned):
    """OpenCV's learned test pattern: on level 0, where both take the image
    as it is, every bit equals OpenCV's; on the resized levels a sample
    that lands on a pixel resized with other rounding may flip a test."""
    img = _scene_image(seed)
    if turned:
        img = _warp(img)[0]
    kp, des = ft.orb_detect_and_compute(img, 1000, device="cpu")
    octave = kp.octave.numpy()
    cv_kps = [
        cv2.KeyPoint(float(x), float(y), float(s), float(a), 0.0, int(o))
        for (x, y), s, a, o in zip(
            kp.pt.numpy(), kp.size.numpy(), kp.angle.numpy(), octave
        )
    ]
    cv_kps, cv_des = cv2.ORB_create(1000).compute(img, cv_kps)
    # OpenCV returns the keypoints grouped by level: pair them by position
    row = {(k.pt, k.octave): i for i, k in enumerate(cv_kps)}
    order = [
        row[((float(x), float(y)), int(o))]
        for (x, y), o in zip(kp.pt.numpy(), octave)
    ]
    assert len(order) == len(cv_kps) > 250
    diff = np.unpackbits(des.numpy() ^ cv_des[order], axis=1).sum(1)
    assert diff[octave == 0].sum() == 0
    assert diff.sum() <= 0.005 * diff.size * 256, diff.sum()


def _numpy_knn(q, t, norm):
    if norm == "hamming":
        bq = np.unpackbits(q, axis=1, bitorder="little").astype(np.int64)
        bt = np.unpackbits(t, axis=1, bitorder="little").astype(np.int64)
        d = (bq[:, None, :] != bt[None, :, :]).sum(2).astype(np.float64)
    else:
        d = np.sqrt(((q[:, None, :].astype(np.float64) - t[None, :, :]) ** 2).sum(2))
    i0 = np.argmin(d, 1)
    d1 = d.copy()
    d1[np.arange(len(q)), i0] = np.inf
    i1 = np.argmin(d1, 1)
    return np.stack([i0, i1], 1), np.stack([d[np.arange(len(q)), i0], d1[np.arange(len(q)), i1]], 1)


@pytest.mark.parametrize("norm", ["hamming", "l2"])
def test_bf_knn_match_equals_numpy(norm):
    rng = np.random.default_rng(4)
    if norm == "hamming":
        q = rng.integers(0, 256, (300, 32), dtype=np.uint8)
        t = rng.integers(0, 256, (500, 32), dtype=np.uint8)
        t[7] = t[3]  # a tie: the lower index wins
        q[0] = t[3]
    else:
        q = rng.integers(0, 40, (300, 128)).astype(np.float32)
        t = rng.integers(0, 40, (500, 128)).astype(np.float32)
        t[9] = t[2]
        q[0] = t[2]
    idx, dist = ft.bf_knn_match(torch.as_tensor(q), torch.as_tensor(t), 2, norm)
    ri, rd = _numpy_knn(q, t, norm)
    assert np.array_equal(idx.numpy(), ri)
    assert np.array_equal(dist.numpy().astype(np.float64), rd.astype(np.float32).astype(np.float64))
    assert idx[0, 0] == (3 if norm == "hamming" else 2) and dist[0, 0] == 0


def test_estimate_rigid_ransac_identical():
    """tests/test_fbr.py::test_ransac_rigid's matches."""
    rng = np.random.default_rng(42)
    d = rng.uniform(-100, 100, (50, 3))
    T_true = np.asarray(math3d.euler_to_matrix4([10.0, -5.0, 3.0], [0.1, -0.05, 0.2]))
    m = np.asarray(math3d.transform3(T_true, d))
    m2 = m.copy()
    out = rng.choice(50, 15, replace=False)
    m2[out] += rng.uniform(-300, 300, (15, 3))
    Tj, ij = jfbr.estimate_rigid_ransac(m2, d, iters=300, inlier_dist=5.0)
    Tp, ip = tfbr.estimate_rigid_ransac(m2, d, iters=300, inlier_dist=5.0)
    assert np.array_equal(Tp, Tj) and np.array_equal(ip, ij)
    np.testing.assert_allclose(Tp, T_true, atol=0.05)


def _fbr_scene(boxes: bool):
    """tests/test_fbr.py::test_register_fbr_end_to_end's scene (the rng
    fixture's seed), optionally with 12 boxes of 2500 points."""
    rng = np.random.default_rng(42)
    world = make_room_cloud(rng, n=20000, size=800.0) - 400.0
    for c in ([100, 50, 200], [-200, 0, 100], [50, -100, -250]):
        world = np.concatenate([world, np.asarray(c) + rng.normal(0, 15, (3000, 3))])
    if boxes:
        r2 = np.random.default_rng(7)
        extra = []
        for _ in range(12):
            lo, sz = r2.uniform(-380, 300, 3), r2.uniform(30, 90, 3)
            extra.append(lo + r2.uniform(0, 1, (2500, 3)) * sz)
        world = np.concatenate([world] + extra)
    T_true = np.asarray(math3d.euler_to_matrix4(np.zeros(3), np.array([0.0, 0.15, 0.0])))
    return world, np.asarray(math3d.transform3(math3d.m4inv(T_true), world))


@pytest.mark.parametrize("detector,boxes", [("orb", False), ("sift", True)])
def test_register_fbr_yaw(detector, boxes):
    world, data = _fbr_scene(boxes)
    fields = dict(panorama=JPanoramaParams(width=720, height=360), detector=detector,
                  ransac_iters=800, inlier_dist=20.0)
    rj = jfbr.register_fbr(world, data, jfbr.FbrParams(**fields))
    rp = tfbr.register_fbr(world, data, interop.fbr_params_from(fields), device="cpu")
    yaw_j = float(np.asarray(math3d.matrix4_to_euler(rj["T"])[0])[1])
    yaw_p = float(np.asarray(math3d.matrix4_to_euler(rp["T"])[0])[1])
    assert rp["n_inliers"] >= 10 and rj["n_inliers"] >= 10
    assert abs(yaw_p - 0.15) < 0.03 and abs(yaw_p - yaw_j) < 0.03, (yaw_p, yaw_j)
