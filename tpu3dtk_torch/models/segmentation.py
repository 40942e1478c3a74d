"""Point-cloud segmentation — the port of ``tpu3dtk.models.segmentation``
(the reference's src/segmentation/: Felzenszwalb-Huttenlocher graph
segmentation, fhsegmentation.cc with its disjoint set; region growing,
src/preg6d/model/rg.cc; the recursive graph cut, graph_cut/).

- :func:`fh_segmentation`: the k-NN graph on the device of the cloud
  (``ops.knn.knn_brute``), then the FH merge over the sorted edges, a
  sequential union-find on the host as in the JAX package
  (:func:`_fh_merge`; the ``fh_merge_time`` span times it).
- :func:`region_growing_segmentation`: the min-label flood over the
  coherent k-NN edges, each sweep on the device, one host read a sweep
  for the stop test.
- :func:`graph_cut_segmentation`: host numpy and scipy, a copy of the
  JAX package's (which is numpy there too).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import knn as knn_ops
from ..utils.metrics import metrics

__all__ = [
    "FHParams", "GraphCutParams", "fh_segmentation", "graph_cut_segmentation",
    "region_growing_segmentation",
]

FH_MERGE = "fh_merge_time"  # metrics timer: the host union-find of fh_segmentation


@dataclasses.dataclass
class FHParams:
    k: int = 8  # kNN graph degree (ref --K)
    threshold: float = 50.0  # FH k-parameter (ref --threshold)
    min_size: int = 20  # post-merge minimum segment size (ref --minSize)


def _points(points, device) -> torch.Tensor:
    """[N, 3] f32 on the tensor's own device, or an array uploaded to
    ``device`` (None: the package default, the first CUDA card)."""
    if isinstance(points, torch.Tensor):
        return points.to(torch.float32)
    from .. import default_device

    dev = default_device() if device is None else torch.device(device)
    return torch.as_tensor(np.asarray(points, np.float32), device=dev)


def _fh_merge(src, dst, w, N: int, params: FHParams) -> np.ndarray:
    """The FH merge over de-duplicated edges (src, dst [E] int, w [E] f32):
    the JAX package's union-find with rank and size, the same comparisons
    in the same f64 arithmetic, run on Python lists (numpy scalar indexing
    costs more than the loop itself).  Returns [N] compacted labels."""
    order = np.argsort(w, kind="stable")
    src_o = src[order].tolist()
    dst_o = dst[order].tolist()
    w_o = w[order].astype(np.float64).tolist()  # f32 values, exactly
    parent = list(range(N))
    rank = [0] * N
    size = [1] * N
    internal = [0.0] * N  # Int per root
    thr = float(params.threshold)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    def union(a, b):
        if rank[a] < rank[b]:
            a, b = b, a
        parent[b] = a
        size[a] += size[b]
        if rank[a] == rank[b]:
            rank[a] += 1
        return a

    for u, v, wgt in zip(src_o, dst_o, w_o):
        a, b = find(u), find(v)
        if a == b:
            continue
        if wgt <= internal[a] + thr / size[a] and wgt <= internal[b] + thr / size[b]:
            internal[union(a, b)] = wgt
    # post-merge small components into their cheapest neighbour
    if params.min_size > 1:
        ms = params.min_size
        for u, v in zip(src_o, dst_o):
            a, b = find(u), find(v)
            if a != b and (size[a] < ms or size[b] < ms):
                union(a, b)
    roots = np.array([find(i) for i in range(N)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def fh_segmentation(points, params: FHParams | None = None, device=None) -> np.ndarray:
    """Segment a cloud; returns [N] int labels (compacted, 0-based).

    FH criterion: merge components A, B over edge w iff
    w <= min(Int(A) + k/|A|, Int(B) + k/|B|) with Int the largest
    internal edge weight, the reference's rule.  ``points`` [N, 3]: a
    tensor (the k-NN runs on its device) or an array (uploaded to
    ``device``; None: the first CUDA card)."""
    params = params or FHParams()
    pts = _points(points, device)
    dev = pts.device
    N = pts.shape[0]
    if N == 0:
        return np.zeros(0, np.int64)
    k = min(params.k + 1, N)
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    idx, d2 = knn_ops.knn_brute(pts, ones, pts, ones, k)
    idx = idx[:, 1:].cpu().numpy()  # drop self
    w = np.sqrt(np.maximum(d2[:, 1:].cpu().numpy(), 0.0))
    src = np.repeat(np.arange(N), idx.shape[1])
    dst = idx.reshape(-1)
    # de-duplicate symmetric edges
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    _, uniq = np.unique(lo.astype(np.int64) * N + hi, return_index=True)
    with metrics.time(FH_MERGE):
        return _fh_merge(lo[uniq], hi[uniq], w.reshape(-1)[uniq], N, params)


def region_growing_segmentation(
    points,
    normals=None,
    k: int = 8,
    angle_thresh_deg: float = 12.0,
    dist_thresh: float = 30.0,
    min_size: int = 10,
    max_iters: int = 200,
    device=None,
) -> np.ndarray:
    """Normal-coherent region growing (ref src/preg6d/model/rg.cc).

    Labels start unique and each sweep propagates the smallest label
    across k-NN edges whose endpoints are normal-coherent (angle <
    ``angle_thresh_deg``) and close (d² < ``dist_thresh``²), both ways
    (a scatter-min back to the neighbours), until nothing changes.
    Returns labels [N]; components smaller than ``min_size`` get -1."""
    from ..ops.normals import estimate_normals_knn

    pts = _points(points, device)
    dev = pts.device
    N = pts.shape[0]
    mask = torch.ones(N, dtype=torch.bool, device=dev)
    if normals is None:
        normals = estimate_normals_knn(pts, mask, torch.zeros(3, device=dev), k=max(k, 10))
    else:
        normals = torch.as_tensor(np.asarray(normals, np.float32), device=dev)
    idx, d2 = knn_ops.knn_brute(pts, mask, pts, mask, k)
    ndot = (normals[:, None, :] * normals[idx]).sum(-1).abs()
    cos_t = float(np.cos(np.deg2rad(angle_thresh_deg)))
    edge_ok = (ndot >= cos_t) & (d2 < dist_thresh**2)
    nbr_idx = torch.where(edge_ok, idx, N).reshape(-1)

    labels = torch.arange(N, dtype=torch.int64, device=dev)
    for _ in range(max_iters):
        nbr = torch.where(edge_ok, labels[idx], N)
        best = torch.minimum(labels, nbr.min(1).values)
        # symmetric propagation: push the own label to the neighbours too
        out = torch.full((N + 1,), N, dtype=torch.int64, device=dev)
        out.scatter_reduce_(0, nbr_idx, best[:, None].expand(-1, k).reshape(-1), "amin")
        new = torch.minimum(best, out[:N])
        if bool((new == labels).all()):
            break
        labels = new
    lab = labels.cpu().numpy()
    out = np.full(N, -1, np.int64)
    uniq, counts = np.unique(lab, return_counts=True)
    next_id = 0
    for u, c in zip(uniq, counts):
        if c >= min_size:
            out[lab == u] = next_id
            next_id += 1
    return out


# ---------------------------------------------------------------------------
# Graph-cut plane segmentation (ref src/segmentation/graph_cut/)
# ---------------------------------------------------------------------------
#
# The reference's recursive cut of the panorama grid graph: per-pixel local
# planes from CDF-weighted windowed PCA (graph_cut.cc:184-258), neighbour
# edge strengths from mutual point-to-plane distances (graph_cut.cc:263-276),
# an isodata threshold that removes weak edges, connected components, a
# plane fit per component and recursion into non-planar ones
# (graph_cut.cc:410-540), then blob colouring (blob_color.cc).  Host numpy
# and scipy, as in the JAX package.


@dataclasses.dataclass
class GraphCutParams:
    width: int = 360        # panorama width (-w)
    height: int = 120       # panorama height (-h)
    window: int = 5         # moving window size (-m)
    min_points: int = 50    # minimum pixels per plane candidate (-n)
    tau: float = 0.6        # planarity threshold (-t)
    cell_size: float = 10.0  # blob-coloring bin size (-c)
    max_depth: int = 8      # recursion guard


def _range_image(points, width, height):
    """Equirectangular range image: nearest point per (az, el) pixel.
    Returns (img [H, W, 3], valid [H, W], pix_of_point [N])."""
    p = np.asarray(points, np.float64)
    r = np.linalg.norm(p, axis=1)
    az = np.arctan2(p[:, 2], p[:, 0])
    el = np.arcsin(np.clip(p[:, 1] / np.maximum(r, 1e-9), -1, 1))
    u = np.clip(((az + np.pi) / (2 * np.pi) * width).astype(np.int64), 0, width - 1)
    v = np.clip(((el + np.pi / 2) / np.pi * height).astype(np.int64), 0, height - 1)
    pix = v * width + u
    order = np.lexsort((r, pix))
    first = np.ones(len(order), bool)
    first[1:] = pix[order][1:] != pix[order][:-1]
    sel = order[first]
    img = np.zeros((height * width, 3))
    valid = np.zeros(height * width, bool)
    img[pix[sel]] = p[sel]
    valid[pix[sel]] = True
    return img.reshape(height, width, 3), valid.reshape(height, width), pix


def _pixel_planes(img, valid, window):
    """Per-pixel local plane by the reference's two-pass CDF-weighted PCA
    (similarity_measure): pass 1 estimates each pixel's neighbour-distance
    normal distribution, pass 2 accumulates the covariance weighted by
    w = 1 - Phi(distance), as shifted-array reductions over the window."""
    from scipy.special import ndtr

    H, W, _ = img.shape
    half = window // 2
    offsets = [
        (dy, dx)
        for dy in range(-half, half + 1)
        for dx in range(-half, half + 1)
        if not (dy == 0 and dx == 0)
    ]

    def shifted(a, dy, dx, fill=0.0):
        out = np.full_like(a, fill)
        ys = slice(max(0, dy), H + min(0, dy))
        yd = slice(max(0, -dy), H + min(0, -dy))
        xs = slice(max(0, dx), W + min(0, dx))
        xd = slice(max(0, -dx), W + min(0, -dx))
        out[yd, xd] = a[ys, xs]
        return out

    sum_d = np.zeros((H, W))
    sq_d = np.zeros((H, W))
    cnt = np.zeros((H, W))
    origin = np.zeros((H, W, 3))
    for dy, dx in offsets:
        xi = shifted(img, dy, dx)
        ok = shifted(valid.astype(np.float64), dy, dx)
        d = np.linalg.norm(xi - img, axis=2) * ok
        sum_d += d
        sq_d += d * d
        cnt += ok
        origin += xi * ok[..., None]
    cnt_s = np.maximum(cnt, 1)
    origin /= cnt_s[..., None]
    mean = sum_d / cnt_s
    var = (sq_d - 2 * mean * sum_d + cnt * mean * mean) / np.maximum(cnt - 1, 1)
    sigma = np.sqrt(np.maximum(var, 0))
    degen = (cnt < 2) | (sigma <= 0)

    cov = np.zeros((H, W, 3, 3))
    wsum = np.zeros((H, W))
    for dy, dx in offsets:
        xi = shifted(img, dy, dx)
        ok = shifted(valid.astype(np.float64), dy, dx)
        d = np.linalg.norm(xi - img, axis=2)
        w = np.where(degen, 1.0, 1.0 - ndtr((d - mean) / np.maximum(sigma, 1e-12))) * ok
        diff = xi - origin
        cov += w[..., None, None] * (diff[..., :, None] * diff[..., None, :])
        wsum += w
    cov /= np.maximum(wsum, 1e-12)[..., None, None]
    _evals, evecs = np.linalg.eigh(cov)  # ascending
    normal = evecs[..., :, 0]
    dist = np.einsum("hwc,hwc->hw", origin, normal)
    ok = valid & (sum_d > 0)
    return normal, dist, ok


def _isodata_threshold(w, eps=1e-4):
    t = w.mean()
    for _ in range(100):
        lo = w[w < t]
        hi = w[w >= t]
        if len(lo) == 0 or len(hi) == 0:
            return t
        t_new = 0.5 * (lo.mean() + hi.mean())
        if abs(t_new - t) <= eps:
            return t_new
        t = t_new
    return t


def _cdf_weights(dist):
    m = dist.mean()
    s = dist.std(ddof=1) if len(dist) > 1 else 0.0
    if s <= 0:
        return np.ones_like(dist)
    from scipy.special import ndtr

    return 1.0 - ndtr((dist - m) / s)


def _fit_plane(pts):
    c = pts.mean(0)
    _, _, vt = np.linalg.svd(pts - c, full_matrices=False)
    n = vt[-1]
    return n, float(c @ n)


def _standard_error(pts, n, d):
    dd = pts @ n - d
    m = len(dd)
    if m < 2:
        return 0.0
    return float(np.sqrt(max((np.sum(dd * dd) - dd.sum() ** 2 / m) / (m - 1), 0.0)))


# blob colouring's voxel neighbourhood: half of the 26 offsets
_BLOB_OFFSETS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1),
                 (1, -1, 0), (1, 0, -1), (0, 1, -1), (1, -1, -1), (1, 1, -1), (1, -1, 1))


def graph_cut_segmentation(points, params: GraphCutParams | None = None) -> np.ndarray:
    """Recursive graph-cut plane segmentation of one scan (the reference's
    bin/graph_cut_segmentation).  Returns per-point segment labels [N]
    (-1 = unsegmented)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    params = params or GraphCutParams()
    pts = np.asarray(points, np.float64)
    H, W = params.height, params.width
    img, valid, pix_of_point = _range_image(pts, W, H)
    normal, pdist, ok = _pixel_planes(img, valid, params.window)

    flat_pts = img.reshape(-1, 3)
    flat_n = normal.reshape(-1, 3)
    flat_d = pdist.reshape(-1)
    okf = ok.reshape(-1)

    # grid edges (right + down) between valid pixels, weighted by the
    # mutual point-to-plane distance (edge_distances)
    idx = np.arange(H * W).reshape(H, W)
    e_u = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    e_v = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    keep = okf[e_u] & okf[e_v]
    e_u, e_v = e_u[keep], e_v[keep]
    e_dist = np.abs(
        np.einsum("ec,ec->e", flat_pts[e_u], flat_n[e_v]) - flat_d[e_v]
    ) + np.abs(
        np.einsum("ec,ec->e", flat_pts[e_v], flat_n[e_u]) - flat_d[e_u]
    )

    n_pix = H * W
    planes = []  # (pixel_index_array, normal, d)

    def cut(pix_mask, eu, ev, edist, depth):
        if len(eu) == 0:
            return
        w = _cdf_weights(edist)
        t = _isodata_threshold(w)
        strong = w >= t
        su, sv = eu[strong], ev[strong]
        g = coo_matrix((np.ones(len(su)), (su, sv)), shape=(n_pix, n_pix))
        _ncomp, label = connected_components(g, directed=False)
        label = np.where(pix_mask, label, -1)  # only this component set's pixels
        for c in np.unique(label[label >= 0]):
            members = np.where(label == c)[0]
            members = members[okf[members]]
            if len(members) < params.min_points:
                continue
            n, d = _fit_plane(flat_pts[members])
            err = _standard_error(flat_pts[members], n, d)
            if err < params.tau or depth >= params.max_depth:
                planes.append((members, n, d))
            else:
                inset = np.zeros(n_pix, bool)
                inset[members] = True
                sel = inset[eu] & inset[ev] & strong
                cut(inset, eu[sel], ev[sel], edist[sel], depth + 1)

    mask0 = np.zeros(n_pix, bool)
    mask0[okf] = True
    cut(mask0, e_u, e_v, e_dist, 0)

    # blob colouring: split each plane's pixels into spatially contiguous
    # segments by voxel connectivity (blob_color.cc)
    pix_label = np.full(n_pix, -1, np.int64)
    next_label = 0
    for members, _n, _d in planes:
        p = flat_pts[members]
        cell = np.floor(p / params.cell_size).astype(np.int64)
        uniq, inv = np.unique(cell, axis=0, return_inverse=True)
        key = {tuple(c): i for i, c in enumerate(uniq)}
        eu2, ev2 = [], []
        for off in _BLOB_OFFSETS:
            for i, c in enumerate(uniq):
                j = key.get((c[0] + off[0], c[1] + off[1], c[2] + off[2]))
                if j is not None:
                    eu2.append(i)
                    ev2.append(j)
        if eu2:
            g = coo_matrix((np.ones(len(eu2)), (eu2, ev2)), shape=(len(uniq), len(uniq)))
            _, blob = connected_components(g, directed=False)
        else:
            blob = np.arange(len(uniq))
        for b in np.unique(blob):
            sel = members[np.isin(inv, np.where(blob == b)[0])]
            if len(sel) >= params.min_points:
                pix_label[sel] = next_label
                next_label += 1

    return pix_label[pix_of_point]
