"""Probabilistic Hough line segments — the port's own copy of OpenCV's
progressive probabilistic Hough transform (``cv::HoughLinesP``, Matas,
Galambos & Kittler 2000), which the JAX package's ``models.floorplan``
calls.  The port imports no OpenCV.

The algorithm is sequential by nature and runs on the host in numpy:
the set pixels are visited in a random order; each votes into a
(theta, rho) accumulator; when its strongest bin reaches the threshold,
the line through the pixel is walked both ways in fixed point, allowing
``max_line_gap`` missing pixels; a segment at least ``min_line_length``
long is emitted and its pixels are unvoted and cleared.

Everything OpenCV's result depends on is mirrored: the ``cv::RNG``
multiply-with-carry generator seeded with all bits set, the f32 table
of ``cos(n·theta)/rho`` and ``sin(n·theta)/rho``, the f32 rho of each
vote rounded half to even (``cvRound``), the angle count of
``computeNumangle`` and the 16-bit fixed-point line walk.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["hough_lines_p"]

_RNG_COEFF = 4164903690
_SHIFT = 16


class _CvRng:
    """cv::RNG: state' = (state mod 2^32)·4164903690 + (state >> 32)."""

    def __init__(self, state: int = (1 << 64) - 1):
        self.state = state & ((1 << 64) - 1)

    def uniform(self, a: int, b: int) -> int:
        s = self.state
        s = ((s & 0xFFFFFFFF) * _RNG_COEFF + (s >> 32)) & ((1 << 64) - 1)
        self.state = s
        return a if a == b else (s & 0xFFFFFFFF) % (b - a) + a


def _numangle(theta: float) -> int:
    n = math.floor(math.pi / theta) + 1
    if n > 1 and abs(math.pi - (n - 1) * theta) < theta / 2:
        n -= 1
    return n


def hough_lines_p(img, rho: float, theta: float, threshold: int,
                  min_line_length: float = 0.0, max_line_gap: float = 0.0) -> np.ndarray:
    """Segments of the set pixels of ``img`` [H, W] (any nonzero value),
    as ``cv2.HoughLinesP(img, rho, theta, threshold, minLineLength=...,
    maxLineGap=...)`` finds them.  Returns [L, 4] int32 rows (x0, y0,
    x1, y1) — OpenCV 5.x's layout — with L = 0 when none is found."""
    image = np.asarray(img)
    if image.ndim != 2:
        raise ValueError("a single-channel image is expected")
    height, width = image.shape
    rho32 = np.float32(rho)
    theta32 = float(np.float32(theta))
    irho = np.float32(1.0) / rho32
    line_length = int(np.rint(min_line_length))
    line_gap = int(np.rint(max_line_gap))
    numangle = _numangle(theta32)
    numrho = int(np.rint(((width + height) * 2 + 1) / float(rho32)))
    n = np.arange(numangle, dtype=np.float64)
    cos_t = (np.cos(n * theta32) * float(irho)).astype(np.float32)
    sin_t = (np.sin(n * theta32) * float(irho)).astype(np.float32)
    offset = (numrho - 1) // 2
    accum = np.zeros((numangle, numrho), np.int32)
    rows = np.arange(numangle)

    mask = image != 0
    ys, xs = np.nonzero(mask)  # row-major, as OpenCV collects them
    nz = list(zip(ys.tolist(), xs.tolist()))
    rng = _CvRng()
    lines = []

    def bins(i, j):
        r = np.rint(np.float32(j) * cos_t + np.float32(i) * sin_t).astype(np.int64)
        return r + offset

    for count in range(len(nz), 0, -1):
        idx = rng.uniform(0, count)
        i, j = nz[idx]
        nz[idx] = nz[count - 1]
        if not mask[i, j]:
            continue
        r = bins(i, j)
        accum[rows, r] += 1
        votes = accum[rows, r]
        max_n = int(np.argmax(votes))  # the first angle with the most votes
        if votes[max_n] < threshold:
            continue

        a = -sin_t[max_n]
        b = cos_t[max_n]
        x0, y0 = j, i
        if abs(a) > abs(b):
            xflag = True
            dx0 = 1 if a > 0 else -1
            dy0 = int(np.rint(np.float32(b) * np.float32(1 << _SHIFT) / np.float32(abs(a))))
            y0 = (y0 << _SHIFT) + (1 << (_SHIFT - 1))
        else:
            xflag = False
            dy0 = 1 if b > 0 else -1
            dx0 = int(np.rint(np.float32(a) * np.float32(1 << _SHIFT) / np.float32(abs(b))))
            x0 = (x0 << _SHIFT) + (1 << (_SHIFT - 1))

        line_end = [None, None]
        for k in range(2):
            gap = 0
            x, y, dx, dy = x0, y0, dx0, dy0
            if k > 0:
                dx, dy = -dx, -dy
            while True:
                if xflag:
                    j1, i1 = x, y >> _SHIFT
                else:
                    j1, i1 = x >> _SHIFT, y
                if j1 < 0 or j1 >= width or i1 < 0 or i1 >= height:
                    break
                if mask[i1, j1]:
                    gap = 0
                    line_end[k] = (j1, i1)
                else:
                    gap += 1
                    if gap > line_gap:
                        break
                x += dx
                y += dy

        good = (abs(line_end[1][0] - line_end[0][0]) >= line_length
                or abs(line_end[1][1] - line_end[0][1]) >= line_length)

        for k in range(2):
            x, y, dx, dy = x0, y0, dx0, dy0
            if k > 0:
                dx, dy = -dx, -dy
            while True:
                if xflag:
                    j1, i1 = x, y >> _SHIFT
                else:
                    j1, i1 = x >> _SHIFT, y
                if mask[i1, j1]:
                    if good:
                        accum[rows, bins(i1, j1)] -= 1
                    mask[i1, j1] = False
                if (j1, i1) == line_end[k]:
                    break
                x += dx
                y += dy

        if good:
            lines.append((line_end[0][0], line_end[0][1], line_end[1][0], line_end[1][1]))
    return np.asarray(lines, np.int32).reshape(-1, 4)
