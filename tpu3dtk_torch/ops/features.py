"""Keypoint detectors, descriptors and a brute-force matcher — the port's
own ORB, SIFT and ``BFMatcher.knnMatch``, which the JAX package's
``models.fbr`` takes from OpenCV.  The port imports no OpenCV; all of
this is torch on the image's device.

- :func:`fast_corners`: FAST-9 on the 16-pixel circle of radius 3 with
  OpenCV's corner score (the largest threshold at which the pixel is
  still a corner, less one) and its strict 3x3 non-maximum suppression;
  the same corners as ``cv2.FastFeatureDetector``.
- :func:`orb_detect_and_compute`: an 8-level pyramid at scale 1.2 (each
  level a bilinear resize of the one above), FAST-9 at threshold 20 with non-maximum suppression away
  from a 31-pixel border, the best 2n of a level by FAST score, then the
  best n by the Harris response (7x7 block, k = 0.04), the intensity
  centroid's orientation over a disc of radius 15, and steered BRIEF:
  256 tests on the level image blurred 7x7 at sigma 2, with OpenCV's
  learned test pattern (``ORB_PATTERN``, a copy of its table, under its
  Apache-2.0 notice).
- :func:`sift_detect_and_compute`: Lowe's SIFT as OpenCV lays it out:
  the image doubled, Gaussian octaves of 3 scales (sigma 1.6), DoG
  extrema refined by up to five quadratic steps, the contrast (0.04)
  and edge (10) tests, a 36-bin orientation histogram (peaks within 80%
  of the highest), the best ``n_features`` by response, and the 4x4x8
  descriptor, clipped at 0.2 and scaled to integers 0-255.
- :func:`bf_knn_match`: exact brute-force k-nearest descriptors, Hamming
  for ORB (bits as ±1 in an f32 product: integer sums of at most 256,
  exact in f32 and in TF32), L2 for SIFT on direct differences (integer
  descriptors: the squared distances are exact integers).  Ties go to
  the lowest index.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "Keypoints", "ORB_PATTERN", "bf_knn_match", "fast_corners", "orb_detect_and_compute",
    "sift_detect_and_compute",
]

# OpenCV's learned test pattern, ``bit_pattern_31_`` of
# modules/features2d/src/orb.cpp: 256 tests as int (x1, y1, x2, y2), stored
# here as int8 (the values lie in [-13, 12]).  OpenCV reads it as 512 points,
# two a test, each rotated by the keypoint's angle and rounded.
# Copyright (C) 2000-2022, Intel Corporation, Willow Garage Inc. and the
# OpenCV contributors.  Licensed under the Apache License, Version 2.0 (the
# "License"); you may not use this table except in compliance with the
# License.  You may obtain a copy of the License at
# http://www.apache.org/licenses/LICENSE-2.0.  Unless required by applicable
# law or agreed to in writing, software distributed under the License is
# distributed on an "AS IS" BASIS, WITHOUT WARRANTIES OR CONDITIONS OF ANY
# KIND, either express or implied.
ORB_PATTERN = np.frombuffer(bytes.fromhex(
    "08fd0905040207f4f509f80207f40cf302f3020c01f90106fef6fefcf3f3f5f8f3fdf4f7"
    "0a040b09f3f8f8f7f507f70c07070c06fcfbfd00f302f4fdf700f9050cfa0cfffd06fe0c"
    "faf3fcf80bf30cf80407050105fd0afd03f9060cf8f9fafefe0bfff6f30cf80af903fbfd"
    "fc02fd07f6f4fa0b05f406f905fa07ff010004fb090b0bf30407040c02ff0404fcf4fe07"
    "f8fbf9f6040b090c00f801f3f3fef802fdfefe03fa09fcf7080c0a070009010307fb0bf6"
    "f3faf5000a070c01fafdfa0c0af70cfcf308f8f4f300f8fc0303070805070af9ff0701f4"
    "03f6050602fc03f6f300f305f3f9f40cf303f508f90cfc0706f60c08f7fff9fafefb000c"
    "f405f90503f608f3f9f9fc05fdfefff9020905f5f5f3fbf3ff0600ff05fd0502fcf3fc0c"
    "f7faf706f4f6f8fc0a020cfd070c0c0cf9f3fa05fc09fd0407ff0c02f906fb01f30bf405"
    "fd07fefa07f80cf9f3f9f5f401fd0c0c02fa0300fc03fef3fff30109070108fa01ff030c"
    "09010c06fff7ff03f3f3f60507070a0c0cfb0c090603070b05f3060a02f40203030804fa"
    "02060cf309f40a03f804f909f50cfcfa010c02f806f707fc020303fe06030b0003fd08f8"
    "07080903f5fbfafcf60bfb0afbf8fd0cf605f70008ff0cfa04fa06f5f60cf80704fe0607"
    "fe00fe0cfbf8fb0207fa0a0cf7f3f8f8fbf3fbfe08f809f3f7f5f70001f801fe07fc0901"
    "fe01fffc0bfa0cf5f4f7fa040307070c05050a0800fc0208f70cfbf30007020cff020107"
    "050b07f7030506f8f3fcf809fb09fdfdfcf9fdf406050800f906fa0cf306fbfe01f6030a"
    "040108fcfefe02f302f40c0cfef300fa04010903faf6fdfbfdf3ff0107050cf504fe05f9"
    "f309f7fb0701080607f80706f9fcf901f80bf9f8f306f4f8020403090afb0c03fafbfa07"
    "08fd09f802f40208f5fef603f4f3f9f7f500f6fb05fd0b08fef3ff0cfff80009f3f5f4fb"
    "f6fef60bfd09fef302fd0302f7f3fc00fc06fdf6fc0cfef9faf5fc0906fd060bf30bfb05"
    "0b0b0c0607fb0cfeff0c0007fcf8fdfef901fa07f3f4f8f3f9fefaf8f805faf7fbfffc05"
    "f307f80a010505f301000af3090c0aff05f80af7ff0b01f3f7fdfa02fff6010cf301f8f6"
    "08f50afa02f303fa07f30cf7f6f6fbf9f6f8f8f304fa0805030c08f3fc02fdfd05f30af4"
    "04f305fff709fc03000303f7f401fa01030204f8f6f6f60908f30c0cf8f4fafb02020307"
    "0a060bf8060808f4f90afa05fdf7fd09fff3ff05fdf9fd04f8fef80304020c0c02fb030b"
    "06f70bf303ff070c0bff0c04fd00fd0604f5040c02fc0201f6faf801f307f501f30cf5f3"
    "06000bf300ff0104f303f7fef708fafdf3faf8fe05f7080a020703f7fffaffff09050bfe"
    "0bfd0cf803000305ff04000a03fa0405f300f60505080c0b080909fa07fc08f4f604f609"
    "07030c0409f90afe07000cfefffa00f5"), dtype=np.int8).reshape(256, 4)

# the FAST circle of radius 3, (dx, dy), in order around it
_RING = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
_HALF_PATCH = 15  # ORB's orientation disc and patch: 31 pixels
_EDGE = 31  # ORB's border on every level
_ORB_LEVELS = 8
_ORB_SCALE = 1.2
_FAST_THRESHOLD = 20
# elements a working tile holds: 2^25 on a card, 2^22 on the CPU
_TILE = {"cuda": 1 << 25, "cpu": 1 << 22}


@dataclasses.dataclass
class Keypoints:
    """Keypoints of one image, as tensors on its device: ``pt`` [K,2] f32
    (x, y) in the input image's pixels, ``response`` [K], ``angle`` [K]
    degrees in [0, 360), ``size`` [K] (the diameter of the described
    region), ``octave`` [K] int64 (ORB: the pyramid level; SIFT: the
    octave of the doubled image)."""

    pt: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    size: torch.Tensor
    octave: torch.Tensor

    def __len__(self) -> int:
        return int(self.pt.shape[0])


def _image(img, device):
    if isinstance(img, torch.Tensor):
        return img.to(torch.float32)
    if device is None:
        from .. import default_device

        device = default_device()
    return torch.as_tensor(np.asarray(img), device=device).to(torch.float32)


def _tile(dev) -> int:
    return _TILE.get(torch.device(dev).type, 1 << 22)


# -- FAST ---------------------------------------------------------------------


def _arc_max(d):
    """Max over the 16 arcs of 9 consecutive ring values of the arc's
    minimum: d [16, ...] -> [...]."""
    dd = torch.cat([d, d[:8]])
    m2 = torch.minimum(dd[:-1], dd[1:])
    m4 = torch.minimum(m2[:-2], m2[2:])
    m8 = torch.minimum(m4[:-4], m4[4:])
    return torch.minimum(m8[:16], dd[8:24]).amax(0)


def _fast_score(img, threshold: int):
    """OpenCV's FAST-9 corner score of every pixel of an integer-valued
    f32 image [H, W]: max(threshold, the largest arc minimum of
    center − ring or ring − center) − 1 where that minimum exceeds the
    threshold, else 0; 0 within 3 pixels of the border."""
    H, W = img.shape
    score = torch.zeros_like(img)
    if H < 7 or W < 7:
        return score
    c = img[3 : H - 3, 3 : W - 3]
    d = torch.stack([c - img[3 + dy : H - 3 + dy, 3 + dx : W - 3 + dx] for dx, dy in _RING])
    best = torch.maximum(_arc_max(d), _arc_max(-d))
    score[3 : H - 3, 3 : W - 3] = torch.where(best > threshold, best - 1, 0.0)
    return score


def _nonmax(score):
    """Pixels whose score is positive and above all 8 neighbours'."""
    p = F.pad(score[None, None], (1, 1, 1, 1))[0, 0]
    H, W = score.shape
    nb = None
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            v = p[dy : dy + H, dx : dx + W]
            nb = v if nb is None else torch.maximum(nb, v)
    return (score > 0) & (score > nb)


def fast_corners(img, threshold: int = 20, device=None):
    """FAST-9 corners of a grayscale image after non-maximum suppression
    (array or tensor; an array goes to ``device``, None: the first CUDA
    card).  Returns (xy [K,2] int64 (x, y), score [K] f32) in row-major
    order."""
    im = _image(img, device)
    score = _fast_score(im, threshold)
    keep = _nonmax(score)
    ys, xs = torch.nonzero(keep, as_tuple=True)
    return torch.stack([xs, ys], 1), score[ys, xs]


# -- ORB ----------------------------------------------------------------------


def _gauss_kernel(ksize: int, sigma: float, dev):
    x = torch.arange(ksize, dtype=torch.float64, device=dev) - (ksize - 1) / 2
    k = torch.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).to(torch.float32)


def _blur(img, sigma: float, ksize: int | None = None):
    """Separable Gaussian blur of [H, W] with reflect-101 borders (ksize
    as OpenCV picks it for float images when None)."""
    if ksize is None:
        ksize = int(round(sigma * 4 * 2 + 1)) | 1
    H, W = img.shape
    k = _gauss_kernel(ksize, sigma, img.device)
    r = ksize // 2
    x = img[None, None]
    rx, ry = min(r, W - 1), min(r, H - 1)
    x = F.pad(x, (rx, rx, 0, 0), mode="reflect" if rx > 0 else "replicate")
    x = F.conv2d(x, k[r - rx : r + rx + 1].view(1, 1, 1, -1))
    x = F.pad(x, (0, 0, ry, ry), mode="reflect" if ry > 0 else "replicate")
    x = F.conv2d(x, k[r - ry : r + ry + 1].view(1, 1, -1, 1))
    return x[0, 0]


def _resize(img, h: int, w: int):
    out = F.interpolate(img[None, None], size=(h, w), mode="bilinear", align_corners=False)[0, 0]
    return torch.clamp(torch.round(out), 0, 255)


def _umax():
    """Half-widths of ORB's orientation disc a row (OpenCV's u_max)."""
    hp = _HALF_PATCH
    vmax = int(math.floor(hp * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(hp * math.sqrt(2.0) / 2))
    umax = [0] * (hp + 2)
    for v in range(vmax + 1):
        umax[v] = int(np.rint(math.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: hp + 1]


def _disc_weights(dev):
    """(u, v, in-disc mask) over the 31 x 31 patch of offsets."""
    umax = torch.as_tensor(_umax(), device=dev)
    o = torch.arange(-_HALF_PATCH, _HALF_PATCH + 1, device=dev)
    v, u = torch.meshgrid(o, o, indexing="ij")
    return u, v, u.abs() <= umax[v.abs()]


def _harris(img, xs, ys, k: float = 0.04, block: int = 7):
    """OpenCV ORB's Harris response at integer pixels (xs, ys) of an
    integer-valued image: Sobel gradients summed over a 7x7 block."""
    sob = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=img.device)
    x = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")
    ix = F.conv2d(x, sob.view(1, 1, 3, 3))[0, 0]
    iy = F.conv2d(x, sob.T.contiguous().view(1, 1, 3, 3))[0, 0]
    box = torch.ones((1, 1, block, block), device=img.device)
    r = block // 2
    prods = torch.stack([ix * ix, iy * iy, ix * iy])[:, None]
    sums = F.conv2d(F.pad(prods, (r, r, r, r)), box)[:, 0]
    a, b, c = sums[0, ys, xs], sums[1, ys, xs], sums[2, ys, xs]
    scale = 1.0 / (4 * block * 255.0)
    return (a * b - c * c - k * (a + b) * (a + b)) * scale**4


def _patches(img, xs, ys, offs_y, offs_x):
    """img[ys + offs_y, xs + offs_x] for keypoints [K] and offsets [...]."""
    W = img.shape[1]
    flat = (ys.view(-1, *([1] * offs_y.ndim)) + offs_y) * W + (xs.view(-1, *([1] * offs_x.ndim)) + offs_x)
    return img.reshape(-1)[flat]


def _orb_level(lvl, n_keep: int, fast_threshold: int, pattern):
    """Keypoints (x, y, score, angle) and packed descriptors [K,32] uint8
    on one pyramid level."""
    dev = lvl.device
    H, W = lvl.shape
    score = _fast_score(lvl, fast_threshold)
    keep = _nonmax(score)
    keep[: _EDGE] = False
    keep[H - _EDGE :] = False
    keep[:, : _EDGE] = False
    keep[:, W - _EDGE :] = False
    ys, xs = torch.nonzero(keep, as_tuple=True)
    if xs.numel() > 2 * n_keep:
        top = torch.topk(score[ys, xs], 2 * n_keep).indices
        ys, xs = ys[top], xs[top]
    resp = _harris(lvl, xs, ys)
    if xs.numel() > n_keep:
        top = torch.topk(resp, n_keep).indices
        ys, xs, resp = ys[top], xs[top], resp[top]
    u, v, disc = _disc_weights(dev)
    pat = _patches(lvl, xs, ys, v, u) * disc
    m10 = (pat * u).sum((1, 2))
    m01 = (pat * v).sum((1, 2))
    ang = torch.rad2deg(torch.atan2(m01, m10)) % 360.0
    blurred = torch.round(_blur(lvl, 2.0, 7))
    rad = torch.deg2rad(ang)
    ca, sa = torch.cos(rad)[:, None], torch.sin(rad)[:, None]
    px = pattern[:, [0, 2]].to(torch.float32)  # [256, 2] x of the two points
    py = pattern[:, [1, 3]].to(torch.float32)
    ox = torch.round(px.reshape(1, -1) * ca - py.reshape(1, -1) * sa).to(torch.int64)
    oy = torch.round(px.reshape(1, -1) * sa + py.reshape(1, -1) * ca).to(torch.int64)
    vals = blurred.reshape(-1)[(ys[:, None] + oy) * W + (xs[:, None] + ox)].view(-1, 256, 2)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int64).view(-1, 32, 8)
    desc = (bits << torch.arange(8, device=dev)).sum(2).to(torch.uint8)
    return xs, ys, resp, ang, desc


def orb_detect_and_compute(img, n_features: int = 500, device=None):
    """ORB keypoints and 256-bit descriptors of a grayscale uint8 image
    (array or tensor; an array goes to ``device``, None: the first CUDA
    card).  Returns (Keypoints, descriptors [K,32] uint8 tensor)."""
    im = _image(img, device)
    dev = im.device
    H, W = im.shape
    factor = 1.0 / _ORB_SCALE
    n_desired = n_features * (1 - factor) / (1 - factor**_ORB_LEVELS)
    per_level, total = [], 0
    for _ in range(_ORB_LEVELS - 1):
        per_level.append(int(round(n_desired)))
        total += per_level[-1]
        n_desired *= factor
    per_level.append(max(n_features - total, 0))
    pattern = torch.as_tensor(ORB_PATTERN.astype(np.int64), device=dev)
    out = []
    lvl = im
    for level in range(_ORB_LEVELS):
        scale = _ORB_SCALE**level
        h, w = int(round(H / scale)), int(round(W / scale))
        if h <= 2 * _EDGE or w <= 2 * _EDGE:
            break
        if level:
            lvl = _resize(lvl, h, w)  # from the level above, as OpenCV builds it
        xs, ys, resp, ang, desc = _orb_level(lvl, per_level[level], _FAST_THRESHOLD, pattern)
        out.append((xs, ys, resp, ang, desc, level, scale))
    if not out:
        e = torch.zeros(0, device=dev)
        return Keypoints(e.view(0, 2), e, e, e, e.to(torch.int64)), torch.zeros(
            (0, 32), dtype=torch.uint8, device=dev)
    pts = torch.cat([torch.stack([xs, ys], 1).to(torch.float32) * s for xs, ys, *_r, s in out])
    kp = Keypoints(
        pt=pts,
        response=torch.cat([o[2] for o in out]),
        angle=torch.cat([o[3] for o in out]),
        size=torch.cat([torch.full((o[0].numel(),), 31.0 * o[6], device=dev) for o in out]),
        octave=torch.cat([torch.full((o[0].numel(),), o[5], device=dev) for o in out]),
    )
    return kp, torch.cat([o[4] for o in out])


# -- SIFT ---------------------------------------------------------------------

_SIFT_LAYERS = 3  # scales an octave
_SIFT_SIGMA = 1.6
_SIFT_CONTRAST = 0.04
_SIFT_EDGE = 10.0
_SIFT_BORDER = 5
_SIFT_STEPS = 5
_ORI_BINS = 36
_ORI_SIG = 1.5
_ORI_PEAK = 0.8
_DESCR_W = 4
_DESCR_BINS = 8
_DESCR_SCL = 3.0
_DESCR_MAG = 0.2
_INT_DESCR = 512.0


def _sift_pyramid(img, n_layers: int, sigma: float):
    """Gaussian octaves [S+3, h, w] of the doubled image and their DoG
    stacks [S+2, h, w]."""
    H, W = img.shape
    base = F.interpolate(img[None, None], size=(2 * H, 2 * W), mode="bilinear",
                         align_corners=False)[0, 0]
    base = _blur(base, math.sqrt(max(sigma * sigma - 1.0, 0.01)))
    n_oct = int(round(math.log2(min(base.shape)) - 2))
    k = 2.0 ** (1.0 / n_layers)
    sig = [sigma] + [
        math.sqrt((sigma * k**i) ** 2 - (sigma * k ** (i - 1)) ** 2) for i in range(1, n_layers + 3)
    ]
    gauss, dogs = [], []
    for o in range(n_oct):
        g = [base if o == 0 else gauss[-1][n_layers][::2, ::2].contiguous()]
        if min(g[0].shape) < 2 * _SIFT_BORDER + 3:
            break
        for i in range(1, n_layers + 3):
            g.append(_blur(g[-1], sig[i]))
        g = torch.stack(g)
        gauss.append(g)
        dogs.append(g[1:] - g[:-1])
    return gauss, dogs


def _box3(x, op, fill: float):
    """``op`` (max or min) over each 3x3x3 neighbourhood of [S, H, W],
    separably, with ``fill`` beyond the borders."""
    for dim in range(3):
        pad = [0, 0] * 3
        pad[2 * (2 - dim)] = pad[2 * (2 - dim) + 1] = 1
        p = F.pad(x, pad, value=fill)
        n = x.shape[dim]
        x = op(op(p.narrow(dim, 0, n), p.narrow(dim, 1, n)), p.narrow(dim, 2, n))
    return x


def _extrema(dog, n_layers: int, contrast: float):
    """(layer, row, col) of the DoG extrema of one octave."""
    thr = math.floor(0.5 * contrast / n_layers * 255.0)
    mx = _box3(dog, torch.maximum, -math.inf)
    mn = _box3(dog, torch.minimum, math.inf)
    ext = (dog.abs() > thr) & (((dog > 0) & (dog >= mx)) | ((dog < 0) & (dog <= mn)))
    ext[0] = False
    ext[-1] = False
    b = _SIFT_BORDER
    ext[:, :b] = False
    ext[:, -b:] = False
    ext[:, :, :b] = False
    ext[:, :, -b:] = False
    return torch.nonzero(ext, as_tuple=True)


def _refine(dog, l, r, c, n_layers: int, contrast: float, edge: float):
    """OpenCV's adjustLocalExtrema on candidates of one octave: up to
    five quadratic steps, then the contrast and edge tests.  Returns the
    kept (l, r, c, xi, xr, xc, response)."""
    S2, H, W = dog.shape
    img_scale = 1.0 / 255.0
    ds, s2, cs = img_scale * 0.5, img_scale, img_scale * 0.25
    alive = torch.ones_like(l, dtype=torch.bool)
    done = torch.zeros_like(alive)
    off = torch.zeros((l.numel(), 3), dtype=dog.dtype, device=dog.device)
    flat = dog.reshape(-1)
    b = _SIFT_BORDER

    def at(dl, dr, dc):
        return flat[((l + dl) * H + (r + dr)) * W + (c + dc)]

    for _ in range(_SIFT_STEPS):
        todo = alive & ~done
        if not bool(todo.any()):
            break
        v = at(0, 0, 0)
        dD = torch.stack([(at(0, 0, 1) - at(0, 0, -1)) * ds, (at(0, 1, 0) - at(0, -1, 0)) * ds,
                          (at(1, 0, 0) - at(-1, 0, 0)) * ds], 1)
        dxx = (at(0, 0, 1) + at(0, 0, -1) - 2 * v) * s2
        dyy = (at(0, 1, 0) + at(0, -1, 0) - 2 * v) * s2
        dss = (at(1, 0, 0) + at(-1, 0, 0) - 2 * v) * s2
        dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) * cs
        dxs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) * cs
        dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) * cs
        Hm = torch.stack([torch.stack([dxx, dxy, dxs], 1), torch.stack([dxy, dyy, dys], 1),
                          torch.stack([dxs, dys, dss], 1)], 1)
        X, info = torch.linalg.solve_ex(Hm, dD)
        X = torch.where((info != 0)[:, None], 0.0, -X)  # (xc, xr, xi)
        off = torch.where(todo[:, None], X, off)
        conv = todo & (X.abs() < 0.5).all(1)
        done |= conv
        move = todo & ~conv
        alive &= ~(move & (X.abs() > 1e8).any(1))
        step = torch.round(X).to(torch.int64)
        c = torch.where(move, c + step[:, 0], c)
        r = torch.where(move, r + step[:, 1], r)
        l = torch.where(move, l + step[:, 2], l)
        inside = (l >= 1) & (l <= n_layers) & (c >= b) & (c < W - b) & (r >= b) & (r < H - b)
        alive &= ~move | inside
        # dropped candidates read a safe pixel until the loop ends
        l = torch.where(alive, l, 1)
        r = torch.where(alive, r, b)
        c = torch.where(alive, c, b)
    keep = alive & done
    l, r, c, off = l[keep], r[keep], c[keep], off[keep]
    v = at(0, 0, 0)
    dD = torch.stack([(at(0, 0, 1) - at(0, 0, -1)) * ds, (at(0, 1, 0) - at(0, -1, 0)) * ds,
                      (at(1, 0, 0) - at(-1, 0, 0)) * ds], 1)
    contr = v * img_scale + (dD * off).sum(1) * 0.5
    dxx = (at(0, 0, 1) + at(0, 0, -1) - 2 * v) * s2
    dyy = (at(0, 1, 0) + at(0, -1, 0) - 2 * v) * s2
    dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) * cs
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    ok = (contr.abs() * n_layers >= contrast) & (det > 0) & (tr * tr * edge < (edge + 1) ** 2 * det)
    return l[ok], r[ok], c[ok], off[ok, 2], off[ok, 1], off[ok, 0], contr[ok].abs()


def _chunks(rad, tile: int, per: int):
    """Keypoint index chunks for windows of radius ``rad`` [K]: sorted by
    radius, each chunk sized so that its keypoints x (2R+1)² x ``per``
    stays within ``tile``, with R the chunk's largest radius.  Yields
    (indices, R)."""
    order = torch.argsort(rad)
    rs = rad[order].tolist()
    a = 0
    while a < len(rs):
        b = a + 1
        while b < len(rs) and (b + 1 - a) * (2 * rs[b] + 1) ** 2 * per <= tile:
            b += 1
        yield order[a:b], int(rs[b - 1])
        a = b


def _orientations(g, l, r, c, scl, tile):
    """36-bin orientation histograms of the keypoints (l, r, c) of one
    octave's Gaussian stack ``g``; returns (keypoint index, angle) of
    every peak within 80% of its histogram's highest."""
    S3, H, W = g.shape
    dev = g.device
    rad = torch.round(3 * _ORI_SIG * scl).to(torch.int64)
    sig_w = _ORI_SIG * scl
    t = torch.zeros((l.numel(), _ORI_BINS), dtype=g.dtype, device=dev)
    f = g.reshape(-1)
    for sel, R in _chunks(rad, tile, 1):
        o = torch.arange(-R, R + 1, device=dev)
        oi, oj = torch.meshgrid(o, o, indexing="ij")
        y = r[sel, None, None] + oi
        x = c[sel, None, None] + oj
        rk = rad[sel, None, None]
        ok = ((oi.abs() <= rk) & (oj.abs() <= rk)
              & (y > 0) & (y < H - 1) & (x > 0) & (x < W - 1))
        y, x = torch.where(ok, y, 1), torch.where(ok, x, 1)
        i = (l[sel] * (H * W))[:, None, None] + y * W + x
        dx = f[i + 1] - f[i - 1]
        dy = f[i - W] - f[i + W]
        wgt = torch.exp(-(oi * oi + oj * oj) / (2 * sig_w[sel, None, None] ** 2))
        ori = torch.rad2deg(torch.atan2(dy, dx)) % 360.0
        mag = torch.sqrt(dx * dx + dy * dy)
        b = torch.round(ori * (_ORI_BINS / 360.0)).to(torch.int64) % _ORI_BINS
        h = torch.zeros((sel.numel(), _ORI_BINS), dtype=g.dtype, device=dev)
        h.scatter_add_(1, b.reshape(b.shape[0], -1), (wgt * mag * ok).reshape(b.shape[0], -1))
        t[sel] = h
    rl = lambda s: torch.roll(t, s, 1)  # noqa: E731
    hist = (rl(2) + rl(-2)) * (1.0 / 16) + (rl(1) + rl(-1)) * (4.0 / 16) + t * (6.0 / 16)
    left, right = torch.roll(hist, 1, 1), torch.roll(hist, -1, 1)
    peak = (hist > left) & (hist > right) & (hist >= _ORI_PEAK * hist.amax(1, keepdim=True))
    kk, jj = torch.nonzero(peak, as_tuple=True)
    hl, hc, hr = left[kk, jj], hist[kk, jj], right[kk, jj]
    b = jj.to(g.dtype) + 0.5 * (hl - hr) / (hl - 2 * hc + hr)
    b = torch.where(b < 0, b + _ORI_BINS, torch.where(b >= _ORI_BINS, b - _ORI_BINS, b))
    ang = 360.0 - (360.0 / _ORI_BINS) * b
    ang = torch.where((ang - 360.0).abs() < 1.2e-7, 0.0, ang)
    return kk, ang


def _descriptors(g, l, ptx, pty, scl, ang, tile):
    """OpenCV's calcSIFTDescriptor for keypoints of one octave: 4x4
    spatial x 8 orientation bins, trilinear votes, clipped at 0.2 and
    scaled to integers 0-255.  Returns [K,128] f32."""
    S3, H, W = g.shape
    dev = g.device
    d, n = _DESCR_W, _DESCR_BINS
    K = l.numel()
    out = torch.zeros((K, d * d * n), dtype=torch.float32, device=dev)
    if K == 0:
        return out
    px, py = torch.round(ptx).to(torch.int64), torch.round(pty).to(torch.int64)
    ori = 360.0 - ang
    ori = torch.where((ori - 360.0).abs() < 1.2e-7, 0.0, ori)
    cos_t, sin_t = torch.cos(torch.deg2rad(ori)), torch.sin(torch.deg2rad(ori))
    hw = _DESCR_SCL * scl
    rad = torch.round(hw * math.sqrt(2.0) * (d + 1) * 0.5).to(torch.int64)
    rad = torch.clamp(rad, max=int(math.sqrt(H * H + W * W)))
    f = g.reshape(-1)
    for sel, R in _chunks(rad, tile, 8):
        k = sel.numel()
        o = torch.arange(-R, R + 1, device=dev)
        oi, oj = torch.meshgrid(o, o, indexing="ij")
        sl = sel
        ct, st = (cos_t[sl] / hw[sl])[:, None, None], (sin_t[sl] / hw[sl])[:, None, None]
        c_rot = oj * ct - oi * st
        r_rot = oj * st + oi * ct
        rbin = r_rot + d / 2 - 0.5
        cbin = c_rot + d / 2 - 0.5
        y = py[sl, None, None] + oi
        x = px[sl, None, None] + oj
        ok = ((oi.abs() <= rad[sl, None, None]) & (oj.abs() <= rad[sl, None, None])
              & (rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
              & (y > 0) & (y < H - 1) & (x > 0) & (x < W - 1))
        y, x = torch.where(ok, y, 1), torch.where(ok, x, 1)
        i = (l[sl] * (H * W))[:, None, None] + y * W + x
        dx = f[i + 1] - f[i - 1]
        dy = f[i - W] - f[i + W]
        wgt = torch.exp((c_rot * c_rot + r_rot * r_rot) * (-1.0 / (d * d * 0.5)))
        gori = torch.rad2deg(torch.atan2(dy, dx)) % 360.0
        mag = torch.sqrt(dx * dx + dy * dy) * wgt * ok
        obin = (gori - ori[sl, None, None]) * (n / 360.0)
        r0, c0, o0 = torch.floor(rbin), torch.floor(cbin), torch.floor(obin)
        rb, cb, ob = rbin - r0, cbin - c0, obin - o0
        r0, c0, o0 = r0.to(torch.int64), c0.to(torch.int64), o0.to(torch.int64) % n
        hist = torch.zeros((k, (d + 2) * (d + 2) * (n + 2)), dtype=torch.float32, device=dev)
        for dr, wr in ((0, 1 - rb), (1, rb)):
            for dc, wc in ((0, 1 - cb), (1, cb)):
                for do, wo in ((0, 1 - ob), (1, ob)):
                    idx = ((r0 + 1 + dr) * (d + 2) + (c0 + 1 + dc)) * (n + 2) + o0 + do
                    idx = torch.where(ok, idx, 0)
                    hist.scatter_add_(1, idx.reshape(k, -1), (mag * wr * wc * wo).reshape(k, -1))
        hist = hist.view(k, d + 2, d + 2, n + 2)[:, 1 : d + 1, 1 : d + 1]
        desc = hist[..., :n].clone()
        desc[..., 0] += hist[..., n]
        desc[..., 1] += hist[..., n + 1]
        desc = desc.reshape(k, -1)
        thr = torch.linalg.vector_norm(desc, dim=1, keepdim=True) * _DESCR_MAG
        desc = torch.minimum(desc, thr)
        nrm = _INT_DESCR / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1.2e-7)
        out[sl] = torch.clamp(torch.round(desc * nrm), 0, 255)
    return out


def sift_detect_and_compute(img, n_features: int = 0, device=None):
    """SIFT keypoints and 128-value descriptors of a grayscale image
    (array or tensor; an array goes to ``device``, None: the first CUDA
    card).  ``n_features`` > 0 keeps that many by response.  Returns
    (Keypoints, descriptors [K,128] f32 tensor of integers 0-255)."""
    im = _image(img, device)
    dev = im.device
    tile = _tile(dev)
    S, sigma = _SIFT_LAYERS, _SIFT_SIGMA
    gauss, dogs = _sift_pyramid(im, S, sigma)
    cand = []
    for o, dog in enumerate(dogs):
        l, r, c = _extrema(dog, S, _SIFT_CONTRAST)
        l, r, c, xi, xr, xc, resp = _refine(dog, l, r, c, S, _SIFT_CONTRAST, _SIFT_EDGE)
        scl = sigma * torch.pow(2.0, (l.to(torch.float32) + xi) / S)
        kk, ang = _orientations(gauss[o], l, r, c, scl, tile)
        cand.append((o, l[kk], r[kk].to(torch.float32) + xr[kk], c[kk].to(torch.float32) + xc[kk],
                     scl[kk], ang, resp[kk]))
    resp = torch.cat([cd[6] for cd in cand])
    order = torch.arange(resp.numel(), device=dev)
    if 0 < n_features < resp.numel():
        order = torch.topk(resp, n_features).indices
    offs = np.cumsum([0] + [cd[1].numel() for cd in cand])
    pts, rs, angs, sizes, octs, descs = [], [], [], [], [], []
    for (o, l, y, x, scl, ang, rsp), a, b in zip(cand, offs[:-1], offs[1:]):
        sel = order[(order >= a) & (order < b)] - int(a)
        if sel.numel() == 0:
            continue
        descs.append(_descriptors(gauss[o], l[sel], x[sel], y[sel], scl[sel], ang[sel], tile))
        f = 2.0 ** o * 0.5
        pts.append(torch.stack([x[sel], y[sel]], 1) * f)
        rs.append(rsp[sel])
        angs.append(ang[sel])
        sizes.append(scl[sel] * 2 * f)
        octs.append(torch.full((sel.numel(),), o, device=dev))
    if not pts:
        e = torch.zeros(0, device=dev)
        return Keypoints(e.view(0, 2), e, e, e, e.to(torch.int64)), torch.zeros((0, 128), device=dev)
    return Keypoints(torch.cat(pts), torch.cat(rs), torch.cat(angs), torch.cat(sizes),
                     torch.cat(octs)), torch.cat(descs)


# -- matching -----------------------------------------------------------------


def _unpack_bits(des):
    """[K,32] uint8 -> [K,256] f32 of ±1 (bit j of byte i is column 8i+j)."""
    bits = (des.to(torch.int64)[..., None] >> torch.arange(8, device=des.device)) & 1
    return bits.reshape(des.shape[0], -1).to(torch.float32) * 2.0 - 1.0


def bf_knn_match(des_q, des_t, k: int = 2, norm: str = "hamming"):
    """The ``k`` nearest descriptors of ``des_t`` to each of ``des_q``
    (tensors on one device): Hamming for packed [K,32] uint8 (ORB), L2
    for [K,128] f32 (SIFT).  Returns (idx [Q,k'] int64, dist [Q,k'] f32)
    with k' = min(k, T), nearest first; ties go to the lowest index."""
    dev = des_q.device
    Q, T = des_q.shape[0], des_t.shape[0]
    k = min(k, T)
    if norm == "hamming":
        bq, bt = _unpack_bits(des_q), _unpack_bits(des_t)
        # ±1 products summed in f32 are exact integers (also under TF32)
        dist = (bq.shape[1] - bq @ bt.T) * 0.5
    elif norm == "l2":
        q, t = des_q.to(torch.float32), des_t.to(torch.float32)
        dist = torch.empty((Q, T), dtype=torch.float32, device=dev)
        step = max(1, _tile(dev) // max(1, T * q.shape[1]))
        for a in range(0, Q, step):
            diff = q[a : a + step, None, :] - t[None, :, :]
            # integer squared distances (exact in f32); the square root
            # correctly rounded (torch's f32 sqrt on the CPU is not always)
            dist[a : a + step] = torch.sqrt((diff * diff).sum(2).double()).float()
    else:
        raise ValueError(f"unknown norm {norm!r}")
    idx, out = [], []
    for _ in range(k):
        j = torch.argmin(dist, 1)  # the first minimum: the lowest index
        idx.append(j)
        out.append(dist.gather(1, j[:, None])[:, 0])
        dist = dist.scatter(1, j[:, None], float("inf"))
    if not idx:
        return (torch.zeros((Q, 0), dtype=torch.int64, device=dev),
                torch.zeros((Q, 0), dtype=torch.float32, device=dev))
    return torch.stack(idx, 1), torch.stack(out, 1)
