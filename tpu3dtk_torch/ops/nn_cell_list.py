"""Cell-list nearest neighbour — the port of the non-kernel half of
``tpu3dtk/ops/nn_pallas.py`` (the reference's CUDA uniform-grid NN,
src/cuda/grid_kernel.cu:314-420, and the sublinear replacement for the
kd-tree hot loop at city scale).

Design, as in the JAX package (sort-based, no pointer chasing):

1. Model and query points are bucketed into cells of edge ``max_dist``
   and sorted by z-major dense cell id (ix*ny + iy)*nz + iz.
2. Queries are processed in chunks of T sorted queries.  The 27-cell
   neighbourhoods of every cell in a chunk's id span [lo, hi] union into
   9 contiguous sorted-model ranges, one per (dx, dy) neighbour column.
3. Kernel K2 ranks each chunk's queries against its 9 ranges and returns
   the winning sorted-model row per query.

Counterparts in ``tpu3dtk/ops/nn_pallas.py``: :func:`cell_list_spec`
(``cell_list_spec``), :class:`CellListModel`, :func:`_dense_ids`,
:func:`build_cell_list_model`, :func:`cell_list_plan_device`,
:func:`cell_list_post_device`, :func:`nn_cell_list_chained`,
:func:`nn_cell_list`.  :func:`cell_list_rows` is the plain PyTorch
version of K2 (``_run_kernel``); the hand-written CUDA kernel is
``ops/nn_cell_list_cuda.py``, and :func:`cell_list_rows_auto` picks
between them by the tensors' device.

What differs from the JAX package, on purpose:

- ranking is exact f32 on direct differences (q − c)², products and sums
  rounded one by one, not the bf16 hi/lo split on chunk-centred
  coordinates; kernel and plain version choose identical rows;
- the sorted clouds are stored ``[N, 4]`` (x, y, z, 0), not ``[8, N]``
  transposed; the ``[W, 29]`` table keeps the JAX package's contents
  (aligned start, shift, length per range) and the kernel reads
  ``start + shift``;
- a winner that is a masked model point is reported "not found" (the
  JAX package does not test the winner's mask);
- there is no RB route: the static width RB is the TPU kernel's need,
  not this card's.  K2 here walks a range of any length and shares long
  chunks out over the card (:func:`cell_list_work_items`), so
  :func:`nn_cell_list_chained` ranks the table as planned: no clamp, no
  overflow lane, no pad rows behind the sorted model, and the grid-box
  exit is the only exactness guard;
- there is no host planner: :func:`nn_cell_list` runs the spec, the
  model build and the chain the ICP and LUM engines run;
- :func:`cell_list_spec` runs on the tensors' device by sort and search:
  one sort of every cloud's cell ids, the per-chunk requirements of
  every pair as searches on it, no array sized by the grid's cell count
  (the JAX package searches ``arange(C + 1)`` per set on the host), and
  the same dict.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.metrics import metrics
from . import nn as nn_ops

__all__ = [
    "CellListModel", "build_cell_list_model", "cell_list_plan_device",
    "cell_list_post_device", "cell_list_rows", "cell_list_rows_auto",
    "cell_list_spec", "cell_list_work_items", "nn_cell_list",
    "nn_cell_list_chained",
]

INF = float("inf")
CELL_LIST_SPEC = "cell_list_spec_time"  # metrics timer: cell_list_spec, to its last read
# plain K2: [chunks, T, columns] scores per tile (256 MB of f32)
_TILE_ELEMS = 1 << 26
_TILE_CHUNKS = 64


def _cdiv(a, b):
    return -(-a // b)


def _round_up(a, b):
    return _cdiv(a, b) * b


def _neighbour_offsets(ny: int, nz: int) -> list[int]:
    """Cell-id offsets of the 9 (dx, dy) neighbour columns."""
    return [(dx * ny + dy) * nz for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


# ---------------------------------------------------------------------------
# K2, plain PyTorch version
# ---------------------------------------------------------------------------


def _clipped_ranges(table, model_rows: int):
    """First row and length ([W, 9] int64 each) of the table's ranges,
    clipped to the model's rows (what K2 and its plain version walk)."""
    starts = (table[:, 2::3] + table[:, 3::3]).long().clamp(0, model_rows)
    lens = torch.minimum(table[:, 4::3].long().clamp(min=0), model_rows - starts)
    return starts, lens


def cell_list_work_items(table, model_rows: int, item_rows: int):
    """Cut every chunk's candidate rows into work items for kernel K2, on
    the table's device and with no host read: the plain version of what
    K2's init kernel computes on the card.

    A chunk's candidates are its 9 clipped ranges laid end to end; item k
    of a chunk is rows [k * item_rows, (k + 1) * item_rows) of that
    sequence.  Returns (prefix [W+1] int64, the exclusive prefix of the
    chunks' item counts, so chunk w owns items prefix[w]..prefix[w+1]-1
    and prefix[W] is their number; totals [W] int64, the chunks' candidate
    rows).  A chunk without candidates has no item."""
    if item_rows < 1:
        raise ValueError(f"cell_list_work_items: item_rows {item_rows} < 1")
    _starts, lens = _clipped_ranges(table, model_rows)
    totals = lens.sum(dim=1)
    prefix = torch.zeros(table.shape[0] + 1, dtype=torch.int64, device=table.device)
    prefix[1:] = torch.cumsum((totals + (item_rows - 1)) // item_rows, dim=0)
    return prefix, totals


def cell_list_rows(table, q_sorted, model_sorted, chunk: int):
    """The plain PyTorch version of kernel K2.

    table [W, 29] int32 (columns 2+3r, 3+3r, 4+3r: aligned start, shift
    and length of range r); q_sorted [W*chunk, 4] f32 cell-sorted
    queries; model_sorted [Mpad, 4] f32 cell-sorted model.  For each
    query the row of ``model_sorted`` with the smallest
    (qx−cx)² + (qy−cy)² + (qz−cz)² (f32, rounded in that order) among
    rows [start+shift, start+shift+length) of its chunk's 9 ranges; the
    earliest range and the lowest row win ties; a query without
    candidates gets row 0 and score +inf.  Returns (rows [W*chunk]
    int32, score [W*chunk] f32)."""
    W = table.shape[0]
    dev = table.device
    Mrows = model_sorted.shape[0]
    starts, lens = _clipped_ranges(table, Mrows)
    lens_host = lens.cpu().numpy()
    q = q_sorted[:, :3].reshape(W, chunk, 3)
    best = torch.full((W, chunk), INF, dtype=torch.float32, device=dev)
    rows = torch.zeros((W, chunk), dtype=torch.int64, device=dev)
    wt = min(W, _TILE_CHUNKS)
    cb = max(1, _TILE_ELEMS // (wt * chunk))
    for w0 in range(0, W, wt):
        w1 = min(W, w0 + wt)
        qt = q[w0:w1]
        qx, qy, qz = qt[:, :, 0:1], qt[:, :, 1:2], qt[:, :, 2:3]
        for r in range(9):
            width = int(lens_host[w0:w1, r].max())
            st = starts[w0:w1, r, None]
            ln = lens[w0:w1, r, None]
            for c0 in range(0, width, cb):
                cols = torch.arange(c0, min(c0 + cb, width), device=dev)
                rr = st + cols  # [wt, k]
                c = model_sorted[rr.clamp(max=Mrows - 1)]  # [wt, k, 4]
                dx = qx - c[:, None, :, 0]
                dy = qy - c[:, None, :, 1]
                dz = qz - c[:, None, :, 2]
                d2 = dx * dx + dy * dy + dz * dz  # [wt, T, k]
                d2 = torch.where((cols < ln)[:, None, :], d2, INF)
                bm, ba = d2.min(dim=2)  # first minimum on ties
                better = bm < best[w0:w1]
                best[w0:w1] = torch.where(better, bm, best[w0:w1])
                rows[w0:w1] = torch.where(better, st + c0 + ba, rows[w0:w1])
    return rows.reshape(-1).to(torch.int32), best.reshape(-1)


def cell_list_rows_auto(table, q_sorted, model_sorted, chunk: int):
    """K2 dispatched on the tensors' device: the CUDA kernel
    (``ops.nn_cell_list_cuda.cell_list_rows_kernel``) for CUDA tensors,
    the plain :func:`cell_list_rows` for CPU tensors."""
    if q_sorted.device.type == "cuda":
        from .nn_cell_list_cuda import cell_list_rows_kernel

        return cell_list_rows_kernel(table, q_sorted, model_sorted, chunk)
    if q_sorted.device.type == "cpu":
        return cell_list_rows(table, q_sorted, model_sorted, chunk)
    raise ValueError(f"no cell-list engine for device {q_sorted.device}")


# ---------------------------------------------------------------------------
# Device-planned cell list: the query side re-planned every ICP iteration
# ---------------------------------------------------------------------------
#
# Exactness guard (the caller re-matches with brute when it fires): oob,
# some point left the static grid box (poses drifted past the margin the
# spec was sized with)


class CellListModel(NamedTuple):
    """Sorted-model side of the device cell list."""

    points: torch.Tensor        # [M, 3] ORIGINAL model points (match frame)
    mmask: torch.Tensor         # [M] bool model validity mask
    model_sorted: torch.Tensor  # [max(M, 1), 4] sorted, permuted coords (w = 0)
    msrc: torch.Tensor          # [M] int32 original index of each sorted row
    cell_start: torch.Tensor    # [C+1] int32 CSR over dense cell ids
    origin: torch.Tensor        # [3] f32 (permuted space)
    cell: float                 # cell edge (an f32 value)


def _permute_axes(pts, perm):
    """``pts`` [N, 3] with its columns in the order ``perm``: column
    views stacked, so no index tensor is built from host data (a CUDA
    graph can hold it)."""
    return torch.stack([pts[:, a] for a in perm], dim=1)


def _dense_ids(pts, origin, cell, dims):
    """Dense cell id of each point and whether it lies outside the box.
    Divides by the cell edge in f32 (no reciprocal), as the JAX package
    does, so points on cell faces land in the same cells."""
    nx, ny, nz = dims
    ij = torch.floor((pts - origin) / cell).to(torch.int32)
    ijc = torch.stack(
        [
            ij[:, 0].clamp(0, nx - 1),
            ij[:, 1].clamp(0, ny - 1),
            ij[:, 2].clamp(0, nz - 1),
        ],
        dim=1,
    )
    ids = (ijc[:, 0] * ny + ijc[:, 1]) * nz + ijc[:, 2]
    oob = ((ij < 0) | (ij != ijc)).any(dim=1)
    return ids, oob


def build_cell_list_model(
    model, mmask, origin, cell, *, dims, perm=(0, 1, 2)
) -> tuple[CellListModel, torch.Tensor]:
    """Model-side build, once per match.  Returns (CellListModel,
    oob_count).  ``perm``: the spec's axis permutation — binning AND the
    stored kernel coordinates run in permuted space (distances are
    permutation-invariant); ``clm.points`` stays original.  The sorted
    model has the model's M rows (one zero row when M = 0, so that K2
    still launches on an empty model): every range ends at or before
    ``cell_start[C]``, the masked-in count, and K2 and
    :func:`cell_list_rows` clip to the rows there are."""
    nx, ny, nz = dims
    C = nx * ny * nz
    M = model.shape[0]
    dev = model.device
    cell = float(np.float32(cell))
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    model_p = _permute_axes(model, perm)
    ids, oob = _dense_ids(model_p, origin, cell, dims)
    ids = torch.where(mmask, ids, C)  # masked sorts last
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]
    cell_start = torch.searchsorted(
        ids_s, torch.arange(C + 1, dtype=ids_s.dtype, device=dev)
    ).to(torch.int32)
    ms = torch.zeros((max(M, 1), 4), dtype=torch.float32, device=dev)
    ms[:M, :3] = model_p[order].to(torch.float32)
    return (
        CellListModel(
            points=model,
            mmask=mmask,
            model_sorted=ms,
            msrc=order.to(torch.int32),
            cell_start=cell_start,
            origin=origin,
            cell=cell,
        ),
        (oob & mmask).sum().to(torch.int32),
    )


def cell_list_plan_device(query, qmask, clm: CellListModel, *, dims,
                          chunk: int = 256, perm=(0, 1, 2)):
    """Query plan on the tensors' device: sort the queries by dense cell
    id and build the per-chunk table.  Returns (table [W, 29] int32,
    q_sorted [W*chunk, 4] f32, order [N] int64, oob_count)."""
    nx, ny, nz = dims
    C = nx * ny * nz
    N = query.shape[0]
    W = _cdiv(N, chunk)
    dev = query.device
    query_p = _permute_axes(query, perm)
    ids, oob = _dense_ids(query_p, clm.origin, clm.cell, dims)
    ids = torch.where(qmask, ids, C)
    order = torch.argsort(ids, stable=True)
    ids_s = torch.full((W * chunk,), C, dtype=ids.dtype, device=dev)
    ids_s[:N] = ids[order]
    q_s = torch.zeros((W * chunk, 4), dtype=torch.float32, device=dev)
    q_s[:N, :3] = query_p[order].to(torch.float32)
    idc = ids_s.view(W, chunk)
    valid_q = idc < C
    lo = torch.where(valid_q, idc, C).min(dim=1).values.long()
    hi = torch.where(valid_q, idc, -1).max(dim=1).values.long()
    any_valid = valid_q.any(dim=1)
    zero = torch.zeros(W, dtype=torch.int32, device=dev)
    cols = [zero, zero]  # query start and count: unused by the device plan
    for off in _neighbour_offsets(ny, nz):
        rs = clm.cell_start[(lo + (off - 1)).clamp(0, C)]
        re = torch.maximum(clm.cell_start[(hi + (off + 2)).clamp(0, C)], rs)
        rs_al = (rs // 128) * 128
        shift = rs - rs_al
        ln = torch.where(any_valid, re - rs, 0)
        cols += [rs_al, shift, ln]
    table = torch.stack(cols, dim=1).contiguous()
    oob_n = (oob & qmask).sum().to(torch.int32)
    return table, q_s, order, oob_n


def cell_list_post_device(rows, order, query, qmask, clm: CellListModel,
                          max_dist2):
    """Map kernel rows back to original model indices, with the exact d²
    from the original coordinates.  A winner that is a masked model
    point (only possible when the query had no candidate) is not found."""
    N = query.shape[0]
    M = clm.points.shape[0]
    idx_sorted = clm.msrc[rows[:N].long().clamp(0, M - 1)].long()
    inv = torch.empty(N, dtype=torch.int64, device=query.device)
    inv[order] = torch.arange(N, device=query.device)
    idx = idx_sorted[inv]
    d2 = nn_ops.sq_norm3(query - clm.points[idx])
    found = qmask & clm.mmask[idx] & (d2 < max_dist2)
    return idx, d2, found


def nn_cell_list_chained(query, qmask, clm: CellListModel, max_dist2,
                         *, dims, chunk: int = 256, perm=(0, 1, 2)):
    """Cell-list NN as a chain of device ops with no host read inside
    (for CUDA tensors): the query plan, K2 on the table as planned
    (ranges of any length) and the exact post.  Returns (idx, d2, found,
    oob) — oob is a DEVICE scalar, the count of masked-in queries outside
    the grid box, which the caller checks lazily."""
    max_dist2 = float(np.float32(max_dist2))
    table, q_s, order, oob = cell_list_plan_device(
        query, qmask, clm, dims=dims, chunk=chunk, perm=tuple(perm)
    )
    rows, _score = cell_list_rows_auto(table, q_s, clm.model_sorted, chunk)
    idx, d2, found = cell_list_post_device(
        rows, order, query, qmask, clm, max_dist2
    )
    return idx, d2, found, oob


# ---------------------------------------------------------------------------
# Sizing: the grid and RB from the clouds, by sort and search on their device
# ---------------------------------------------------------------------------

_SPEC_PERMS = ((0, 1, 2), (2, 0, 1), (1, 2, 0))
_SPEC_CHUNKS = (256, 128)


def _spec_pieces(points) -> list:
    """``points`` as a list of [N, 3] clouds: a sequence of clouds is the
    cloud in pieces, anything else is one cloud."""
    if isinstance(points, (list, tuple)) and all(np.ndim(p) == 2 for p in points):
        return list(points)
    return [points]


def _spec_requirements(clouds, used, pair_sets, lo, dims, cell):
    """Each query chunk's candidate-range requirement, for every axis
    permutation, chunk size and pair, in one batch on the clouds' device.

    Every used cloud is binned once (f64 ``floor((x - lo) / cell)``,
    clamped, as numpy bins it) and its ids under permutation j become the
    keys ``(j * sets + set) * C + id``, sorted once over all of them.  A
    model set's ``cell_start[x]`` is then a search of its key on the
    sorted keys less the first row of its block, and a query set's sorted
    ids are its block: nothing is sized by the cell count C.  Returns (req
    [3, rows] int64 on the host, the chunk rows per pair for each chunk
    size)."""
    dev = clouds[used[0]].device
    sizes = np.asarray([clouds[s].shape[0] for s in used], np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    N, U, P = int(starts[-1]), len(used), len(_SPEC_PERMS)
    C = dims[0] * dims[1] * dims[2]  # the same under every permutation
    x = torch.cat([clouds[s] for s in used]).to(torch.float64)
    # a tensor divisor: CUDA would multiply by the reciprocal of a host
    # scalar, which can round a point on a cell face into the cell below
    cell_t = torch.full((), cell, dtype=torch.float64, device=dev)
    lo_t = torch.as_tensor(lo, device=dev)
    top = torch.as_tensor(np.asarray(dims, np.float64) - 1, device=dev)
    ij = torch.minimum(torch.floor((x - lo_t) / cell_t).clamp(min=0), top).long()
    set_of = torch.repeat_interleave(
        torch.arange(U, device=dev), torch.as_tensor(sizes, device=dev), output_size=N
    )
    keys = torch.sort(torch.cat([
        (j * U + set_of) * C + (ij[:, a] * dims[b] + ij[:, b]) * dims[c] + ij[:, c]
        for j, (a, b, c) in enumerate(_SPEC_PERMS)
    ])).values
    # the chunk rows, host side: first and last sorted query row, and the
    # query and model set of each
    cols, widths = [], []
    for chunk in _SPEC_CHUNKS:
        W = np.asarray([_cdiv(int(sizes[q]), chunk) for _m, q in pair_sets], np.int64)
        k = np.repeat(np.arange(len(pair_sets)), W)
        w = np.arange(int(W.sum())) - np.repeat(np.cumsum(W) - W, W)
        m_u, q_u = (np.asarray([ps[i] for ps in pair_sets], np.int64)[k] for i in (0, 1))
        first = starts[q_u] + w * chunk
        last = starts[q_u] + np.minimum(w * chunk + chunk, sizes[q_u]) - 1
        cols.append(np.stack([first, last, q_u, m_u, starts[m_u]]))
        widths.append(W)
    first, last, q_u, m_u, m_start = torch.as_tensor(np.concatenate(cols, 1), device=dev)
    j = torch.arange(P, device=dev)[:, None]  # [P, 1]
    offs = torch.as_tensor(
        [_neighbour_offsets(dims[b], dims[c]) for _a, b, c in _SPEC_PERMS], device=dev
    )[:, None]  # [P, 1, 9]
    lo_id = keys[j * N + first] - (j * U + q_u) * C  # [P, rows]
    hi_id = keys[j * N + last] - (j * U + q_u) * C
    x = torch.stack([lo_id[..., None] + offs - 1, hi_id[..., None] + offs + 2]).clamp(0, C)
    model_key = ((j * U + m_u) * C)[..., None]
    s, e = torch.searchsorted(keys, model_key + x) - (j * N + m_start)[..., None]
    req = ((e - s).clamp(min=0) + s % 128).amax(-1)
    return req.cpu().numpy(), widths  # the second and last host read


@metrics.time(CELL_LIST_SPEC)
def cell_list_spec(points, max_dist, headroom=1.5,
                   margin_cells=4, max_cells=64_000_000,
                   vmem_budget=12_000_000, queries=None,
                   model_sets=None, pairs=None, device=None):
    """Sizing for the device cell list: grid origin/dims over the cloud
    bbox (+margin for pose drift) and the static RB from the observed
    per-chunk candidate range lengths.  Returns the same dict as the JAX
    package's ``cell_list_spec`` for the same input.

    Tries the 3 cyclic AXIS PERMUTATIONS x chunk sizes 256/128 and
    returns the smallest-RB configuration: dict(origin, dims, RB, chunk,
    perm, cap_over), or None when nothing fits (the caller then stays on
    the brute engine).  The permutation matters because candidate-range
    length is driven by fast-axis COLUMN occupancy: a city cloud's dense
    ground plane makes z-fastest columns huge, while vertical-fastest
    columns stay at ground+facade thickness.  ``vmem_budget`` caps RB as
    in the JAX package (the TPU's scratch size; kept so that both
    packages plan alike — whether this card should keep the cap is a
    measurement question).  In the port RB and ``cap_over`` clamp
    nothing and size no lane: they only size the engine gate
    (``models.sequence``) and keep the dict the JAX package's.

    ``points``, the sets in ``model_sets`` and ``queries`` are numpy
    arrays or tensors; ``points`` may also be a sequence of clouds, the
    cloud in pieces (the bbox of their concatenation).  A cloud passed
    twice, as the same object, is uploaded and binned once.  The work
    runs on ``device``, else on the tensors' device, else on the package
    default: one bbox read, the binning and one sort on the device, the
    per-chunk requirements of every pair in one batch and one read, and
    the choice from them on the host, as in the JAX package."""
    pieces = _spec_pieces(points)
    if device is None:
        device = next(
            (c.device for c in [*pieces, *(model_sets or ()), *(queries or ())]
             if isinstance(c, torch.Tensor)),
            None,
        )
    if device is None:
        from .. import default_device

        device = default_device()
    clouds, slot = [], {}

    def upload(c):
        if id(c) not in slot:
            slot[id(c)] = len(clouds)
            clouds.append(torch.as_tensor(c, device=device)[:, :3])
        return slot[id(c)]

    whole = torch.cat([clouds[upload(p)] for p in pieces])
    lo_hi = torch.stack(torch.aminmax(whole, dim=0)).to(torch.float64)
    lo_hi = lo_hi.cpu().numpy()  # the first host read
    cell = float(max_dist)
    lo = lo_hi[0] - margin_cells * cell
    hi = lo_hi[1] + margin_cells * cell
    dims = [int(np.ceil((hi[a] - lo[a]) / cell)) + 1 for a in range(3)]
    if model_sets is None:
        clouds.append(whole)
        model_slots = [len(clouds) - 1]
    else:
        model_slots = [upload(m) for m in model_sets]
    query_slots = None if queries is None else [upload(q) for q in queries]
    if pairs is None:
        if queries is None:
            pairs = [(mi, None) for mi in range(len(model_slots))]
        else:
            pairs = [
                (mi, qi)
                for mi in range(len(model_slots))
                for qi in range(len(query_slots))
            ]
    pair_slots = [
        (model_slots[mi],
         query_slots[qi] if qi is not None and query_slots else model_slots[mi])
        for mi, qi in pairs
    ]
    used = sorted({s for ps in pair_slots for s in ps})
    local = {s: u for u, s in enumerate(used)}
    pair_sets = [(local[m], local[q]) for m, q in pair_slots]
    # the cell count is the same under every permutation: the JAX
    # package's test of max_cells, once per permutation, takes all or none
    if dims[0] * dims[1] * dims[2] > max_cells or not pairs:
        return None
    reqs, widths = _spec_requirements(clouds, used, pair_sets, lo, dims, cell)
    best = None
    for perm, req_p in zip(_SPEC_PERMS, reqs):
        row = 0
        for chunk, W in zip(_SPEC_CHUNKS, widths):
            # Per-chunk candidate-range requirements against the ACTUAL
            # model sets.  RB is sized at the p99 requirement x headroom:
            # in the JAX package the rare chunks that straddle slow-axis
            # row transitions are repaired exactly by its brute overflow
            # lane, provided their query count stays within its cap.
            ends = row + np.cumsum(W)
            per_pair_reqs = np.split(req_p[row:ends[-1]], ends[:-1] - row)
            row = int(ends[-1])
            all_req = np.concatenate(per_pair_reqs)
            if len(all_req) == 0:
                continue
            rb = max(128, int(np.percentile(all_req, 99.0)))
            RB = _round_up(int(rb * min(headroom, 1.3)), 128)
            rb_limit = (
                vmem_budget // (8 * chunk + 9 * 32) // 128
            ) * 128
            RB = max(128, min(RB, rb_limit))
            # worst single invocation's flagged queries must fit the JAX
            # package's lane
            over_q = max(
                int((req > RB).sum()) * chunk for req in per_pair_reqs
            )
            if over_q > 24576:
                continue
            # lane capacity: 3x the worst estimated overflow (pose
            # drift can grow it), floor 8192
            cap_over = int(_round_up(max(8192, 3 * over_q), 4096))
            cand = dict(
                origin=lo[list(perm)].astype(np.float32),
                dims=tuple(dims[a] for a in perm), RB=int(RB),
                chunk=int(chunk), perm=perm, cap_over=cap_over,
            )
            if best is None or cand["RB"] < best["RB"]:
                best = cand
            break  # larger chunks are better at equal feasibility
    return best


# ---------------------------------------------------------------------------
# NN of two numpy clouds through the same chain
# ---------------------------------------------------------------------------


def nn_cell_list(model, mmask, query, qmask, max_dist2, chunk: int = 256,
                 device=None):
    """Grid NN of two numpy clouds.  Same contract as ``ops.nn.nn_brute``:
    numpy in, numpy out (idx [Q] into ``model``, d2 [Q] f32, found [Q]
    bool with strict d2 < max_dist2), on ``device`` (the package default
    when None).  The spec's grid box holds the masked-in points of both
    clouds; :func:`build_cell_list_model` and :func:`nn_cell_list_chained`
    answer.  Where no spec fits (no masked-in point on a side, or a grid
    over ``max_cells``) or a point is counted outside the box anyway, the
    brute engine answers, exact too."""
    if device is None:
        from .. import default_device

        device = default_device()
    m = torch.as_tensor(np.asarray(model, np.float32), device=device)
    mm = torch.as_tensor(np.asarray(mmask, bool), device=device)
    q = torch.as_tensor(np.asarray(query, np.float32), device=device)
    qm = torch.as_tensor(np.asarray(qmask, bool), device=device)
    max_dist = float(np.sqrt(max_dist2))
    m_in, q_in = m[mm], q[qm]
    spec = None
    if len(m_in) and len(q_in):
        spec = cell_list_spec(
            [m_in, q_in], max_dist, model_sets=[m_in], queries=[q_in]
        )
    if spec is not None:
        perm = tuple(spec["perm"])
        clm, oob_m = build_cell_list_model(
            m, mm, spec["origin"], max_dist, dims=spec["dims"], perm=perm
        )
        out = nn_cell_list_chained(
            q, qm, clm, max_dist2, dims=spec["dims"], chunk=chunk, perm=perm
        )
        if int(oob_m + out[3]) == 0:
            return tuple(x.cpu().numpy() for x in out[:3])
    out = nn_ops.nn_brute_auto(q, qm, m, mm, max_dist2)
    return tuple(x.cpu().numpy() for x in out)
