"""The cell-list NN of the port (``tpu3dtk_torch.ops.nn_cell_list``, the
plain version of kernel K2 on the CPU) against the JAX package's
(``tpu3dtk.ops.nn_pallas``, its Pallas kernel in interpret mode) and
against an exact f64 oracle, on the same numpy inputs.

Bounds:
- the host-side spec, the sorted model and the per-chunk table are
  integer or copied data: equal entry for entry;
- against the cKDTree f64 oracle the port is exact: it ranks in exact f32
  on direct differences, so on random data (no two candidates within f32
  rounding of each other) ``found`` and the chosen index are identical;
- against the JAX chain: its 3-pass bf16 split ranking may swap
  candidates closer than ~1.2e-5 · chunk extent² (nn_pallas.py:50-57), so
  ``found`` agrees on >= 0.999 of the queries and the chosen d² lies
  within 2 · 1.2e-5 · extent² of the port's (the bound
  tests/test_nn_pallas.py uses)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from tpu3dtk.ops import nn_pallas as npl
from tpu3dtk_torch import interop
from tpu3dtk_torch.ops import nn as tnn
from tpu3dtk_torch.ops import nn_cell_list as ncl
from tpu3dtk_torch.ops import nn_cell_list_cuda

from helpers.clouds import DeviceOps
from helpers.clouds import city_cloud as _city_cloud


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run has six test processes, and
    eight spinning threads each slow every process on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_jbuild = jax.jit(
    npl.build_cell_list_model, static_argnames=("dims", "RB", "perm")
)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _oracle(q, qmask, m, mmask, md2):
    """Exact NN in f64 over the masked-in model: (idx into m, d2, found)."""
    midx = np.flatnonzero(mmask)
    if len(midx) == 0:
        return np.zeros(len(q), np.int64), np.full(len(q), np.inf), np.zeros(len(q), bool)
    d, k = cKDTree(m[midx].astype(np.float64)).query(q.astype(np.float64))
    return midx[k], d**2, qmask & (d**2 < md2)


def _build_both(model, mmask, spec, max_dist):
    perm = tuple(spec["perm"])
    jclm, joob = _jbuild(
        jnp.asarray(model), jnp.asarray(mmask), jnp.asarray(spec["origin"]),
        jnp.float32(max_dist), dims=spec["dims"], RB=spec["RB"], perm=perm,
    )
    tclm, toob = ncl.build_cell_list_model(
        _t(model), _t(mmask), spec["origin"], max_dist, dims=spec["dims"], perm=perm,
    )
    return jclm, int(joob), tclm, int(toob)


def _chained_both(q, qmask, jclm, tclm, spec, md2):
    """The JAX chain with the spec's RB clamp and lane, the port's chain
    (which has neither) on the same spec: (idx, d2, found, overflow, oob)
    and (idx, d2, found, oob) as numpy."""
    kw = dict(dims=spec["dims"], chunk=spec["chunk"], perm=tuple(spec["perm"]))
    jout = npl.nn_cell_list_chained(
        jnp.asarray(q), jnp.asarray(qmask), jclm, jnp.float32(md2),
        RB=spec["RB"], cap_over=spec["cap_over"], **kw,
    )
    tout = ncl.nn_cell_list_chained(_t(q), _t(qmask), tclm, md2, **kw)
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


def _assert_same_spec(got, want):
    assert want is not None and got is not None
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def _specs(points, max_dist, **kw):
    """(the port's spec on CPU tensors: the cloud in pieces, one tensor
    per numpy cloud, so a set passed as model and query is the same
    tensor; the JAX package's spec of the concatenated cloud)."""
    pieces = points if isinstance(points, list) else [points]
    want = npl.cell_list_spec(np.concatenate(pieces), max_dist, **kw)
    sets = [*pieces, *(kw.get("model_sets") or ()), *(kw.get("queries") or ())]
    t = {id(c): _t(c) for c in sets}
    for k in ("model_sets", "queries"):
        if kw.get(k) is not None:
            kw[k] = [t[id(c)] for c in kw[k]]
    got = ncl.cell_list_spec([t[id(p)] for p in pieces], max_dist, **kw)
    return got, want


def _window1(clouds, closing=False):
    pairs = [(i - 1, i) for i in range(1, len(clouds))]
    if closing:
        pairs.append((0, len(clouds) - 1))  # bremen.net's closing link
    return dict(headroom=2.0, model_sets=clouds, queries=clouds, pairs=pairs)


SPEC_KINDS = ["uniform", "city", "closing_pair", "no_queries", "other_queries",
              "cell_faces", "max_cells", "chunk_128"]


@pytest.mark.parametrize("kind", SPEC_KINDS)
def test_cell_list_spec_equals_jax(rng, kind):
    """The port's spec (sort and search on CPU tensors) equals the JAX
    package's (numpy) entry for entry."""
    if kind in ("uniform", "city"):
        if kind == "uniform":
            clouds = [rng.uniform(0, 600, (3000, 3)).astype(np.float32) for _ in range(3)]
            max_dist = 25.0
        else:
            clouds = [_city_cloud(rng, 6000) + np.float32(5 * k) for k in range(3)]
            max_dist = 150.0
        got, want = _specs(clouds, max_dist, **_window1(clouds))
        _assert_same_spec(got, want)
        # the numpy form, on the concatenated cloud
        _assert_same_spec(ncl.cell_list_spec(
            np.concatenate(clouds), max_dist, device="cpu", **_window1(clouds)
        ), want)
        if kind == "city":
            assert tuple(got["perm"]) != (0, 1, 2)  # the perm search mattered
        # the simple forms too: union model, with and without queries
        for extra in ({}, {"queries": clouds[:2]}):
            _assert_same_spec(*_specs(clouds[0], max_dist, **extra))
    elif kind == "closing_pair":
        clouds = [_city_cloud(rng, 4000) + np.float32(5 * k) for k in range(4)]
        _assert_same_spec(*_specs(clouds, 150.0, **_window1(clouds, closing=True)))
    elif kind == "no_queries":
        # each model set is its own query set
        clouds = [rng.uniform(0, 500, (2000 + 700 * k, 3)).astype(np.float32) for k in range(3)]
        got, want = _specs(clouds, 25.0, model_sets=clouds)
        _assert_same_spec(got, want)
    elif kind == "other_queries":
        clouds = [_city_cloud(rng, 5000) for _ in range(2)]
        queries = [(c + rng.normal(0, 20, c.shape)).astype(np.float32) for c in clouds]
        queries.append(rng.uniform(0, 3000, (1500, 3)).astype(np.float32))
        _assert_same_spec(*_specs(clouds, 150.0, model_sets=clouds, queries=queries))
        _assert_same_spec(*_specs(
            clouds, 150.0, model_sets=clouds, queries=queries, pairs=[(0, 2), (1, 0), (1, 1)]
        ))
    elif kind == "cell_faces":
        # every coordinate a multiple of the cell edge, and so is the grid
        # origin: each point sits exactly on a cell face
        cell = 25.0
        clouds = [
            (np.round(rng.uniform(0, 900, (3000, 3)) / cell) * cell).astype(np.float32)
            for _ in range(3)
        ]
        _assert_same_spec(*_specs(clouds, cell, **_window1(clouds, closing=True)))
        _assert_same_spec(*_specs(clouds[1], cell, queries=clouds))
    elif kind == "max_cells":
        # the dims of every permutation have the same product, so
        # max_cells takes every permutation or none
        clouds = [_city_cloud(rng, 3000) for _ in range(2)]
        got, want = _specs(clouds, 150.0, **_window1(clouds))
        _assert_same_spec(got, want)
        C = int(np.prod(want["dims"]))
        got, want = _specs(clouds, 150.0, max_cells=C, **_window1(clouds))
        _assert_same_spec(got, want)
        got, want = _specs(clouds, 150.0, max_cells=C - 1, **_window1(clouds))
        assert want is None and got is None
    else:
        # a dense cloud and a small budget: at chunk 256 too many chunks
        # exceed RB for the overflow lane (over_q > 24576), at 128 not
        cloud = rng.uniform(0, 300, (40000, 3)).astype(np.float32)
        got, want = _specs(cloud, 25.0, vmem_budget=600_000)
        _assert_same_spec(got, want)
        assert got["chunk"] == 128
        got, want = _specs(cloud, 25.0, vmem_budget=400_000)
        assert want is None and got is None


def test_cell_list_spec_sizes_nothing_by_the_grid(rng):
    """A sparse cloud in a large grid: no tensor the spec makes has as
    many elements as the grid has cells, and it reads no scalar."""
    clouds = [rng.uniform(0, 10000, (3000, 3)).astype(np.float32) for _ in range(3)]
    tc = [_t(c) for c in clouds]
    with DeviceOps() as ops:
        got = ncl.cell_list_spec(tc, 50.0, **_window1(tc, closing=True))
    want = npl.cell_list_spec(np.concatenate(clouds), 50.0, **_window1(clouds, closing=True))
    _assert_same_spec(got, want)
    C = int(np.prod(got["dims"]))
    assert ops.largest >= 3 * 9000  # the sorted keys: 3 permutations x 9000 points
    assert C > 100 * ops.largest
    assert ops.scalar_reads == 0


@pytest.mark.parametrize("kind", ["uniform", "city"])
def test_model_and_plan_equal_jax(rng, kind):
    """build_cell_list_model and cell_list_plan_device entry for entry:
    the port's sorted model is the JAX package's first M rows (no pad
    rows), its plan the JAX plan's table, sorted queries, order and
    box-exit count."""
    if kind == "uniform":
        model = rng.uniform(0, 500, (3000, 3)).astype(np.float32)
        max_dist = 25.0
    else:
        model = _city_cloud(rng, 5000)
        max_dist = 150.0
    M = len(model)
    mmask = rng.uniform(size=M) > 0.2
    query = (model[rng.permutation(M)[:1111]] + rng.normal(0, 3, (1111, 3))).astype(np.float32)
    # snap some points onto cell faces: the f32 division must bin them alike
    query[:50] = np.round(query[:50] / max_dist) * max_dist
    qmask = rng.uniform(size=len(query)) > 0.1
    spec = npl.cell_list_spec(model[mmask], max_dist, queries=[query[qmask]])
    jclm, joob, tclm, toob = _build_both(model, mmask, spec, max_dist)
    assert joob == toob == 0
    np.testing.assert_array_equal(tclm.msrc.numpy(), np.asarray(jclm.msrc))
    np.testing.assert_array_equal(tclm.cell_start.numpy(), np.asarray(jclm.cell_start))
    assert tclm.model_sorted.shape == (M, 4)
    np.testing.assert_array_equal(
        tclm.model_sorted.numpy()[:, :3], np.asarray(jclm.model_sorted)[:3, :M].T
    )
    assert not tclm.model_sorted.numpy()[:, 3].any()
    assert tclm.cell == float(jclm.cell)
    perm = tuple(spec["perm"])
    jt, jq, jorder, _jmax, joobq = npl.cell_list_plan_device(
        jnp.asarray(query), jnp.asarray(qmask), jclm,
        dims=spec["dims"], chunk=spec["chunk"], perm=perm,
    )
    tt, tq, torder, toobq = ncl.cell_list_plan_device(
        _t(query), _t(qmask), tclm, dims=spec["dims"], chunk=spec["chunk"], perm=perm,
    )
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(tq.numpy()[:, :3], np.asarray(jq)[:3].T)
    assert int(toobq) == int(joobq) == 0
    assert tt.dtype == torch.int32 and tt.shape == (-(-len(query) // spec["chunk"]), 29)


def _cases(rng):
    # tests/test_nn_pallas.py:37-50 (masked and sparse), :63-103 (chained)
    M = 1000
    m = rng.uniform(0, 2000, (M, 3)).astype(np.float32)
    q = rng.uniform(0, 2000, (300, 3)).astype(np.float32)
    yield "masked_sparse", m, rng.uniform(size=M) > 0.3, q, np.ones(300, bool), 50.0
    M, Q = 6000, 2000
    model = rng.uniform(0, 500, (M, 3)).astype(np.float32)
    query = (model[rng.permutation(Q) % M] + rng.normal(0, 3, (Q, 3))).astype(np.float32)
    yield "chained_6000x2000", model, np.ones(M, bool), query, np.ones(Q, bool), 25.0
    c = _city_cloud(rng, 5000)
    yield "city", c, np.ones(len(c), bool), (c[::3] + rng.normal(0, 20, (len(c[::3]), 3))).astype(np.float32), np.ones(len(c[::3]), bool), 150.0


@pytest.mark.parametrize(
    "case", ["masked_sparse", "chained_6000x2000", "city", "long_ranges"]
)
def test_chained_matches_oracle_and_jax(rng, case):
    """The chain the engines run (the table as planned, no clamp, no
    lane): exact against the f64 oracle and the port's brute engine; the
    JAX chain (with its RB clamp and lane) within its rank bound;
    ``nn_cell_list`` gives the same answers; on the CPU no K2 launch.
    "long_ranges": the JAX chain at RB = 128, far below the chunks'
    candidate ranges, so its lane repairs the chunks beyond it; the port
    ranks those ranges as they are."""
    if case == "long_ranges":
        m, mmask, q, qmask, spec = _overflow_setup(rng)
        max_dist = 25.0
        spec = dict(spec, RB=128, cap_over=32768)
    else:
        _, m, mmask, q, qmask, max_dist = next(c for c in _cases(rng) if c[0] == case)
        spec = npl.cell_list_spec(m[mmask], max_dist, queries=[q])
    assert spec is not None
    md2 = max_dist**2
    jclm, _, tclm, _ = _build_both(m, mmask, spec, max_dist)
    launches = nn_cell_list_cuda.cell_list_rows_kernel.launches
    (jidx, jd2, jfound, jovf, joob), (tidx, td2, tfound, toob) = _chained_both(
        q, qmask, jclm, tclm, spec, md2
    )
    assert nn_cell_list_cuda.cell_list_rows_kernel.launches == launches  # CPU: plain K2
    assert int(toob) == 0 and not jovf and int(joob) == 0
    if case == "long_ranges":
        table = ncl.cell_list_plan_device(
            _t(q), _t(qmask), tclm, dims=spec["dims"], chunk=spec["chunk"],
            perm=tuple(spec["perm"]),
        )[0]
        assert int((table[:, 3::3] + table[:, 4::3]).max()) > 2 * spec["RB"]
    oidx, od2, ofound = _oracle(q, qmask, m, mmask, md2)
    np.testing.assert_array_equal(tfound, ofound)
    np.testing.assert_array_equal(tidx[ofound], oidx[ofound])
    np.testing.assert_allclose(td2[ofound], od2[ofound], rtol=1e-5, atol=1e-4)
    # the port's own brute engine: identical answers where found
    bidx, bd2, bfound = tnn.nn_brute(_t(q), _t(qmask), _t(m), _t(mmask), md2)
    np.testing.assert_array_equal(tfound, bfound.numpy())
    np.testing.assert_array_equal(tidx[tfound], bidx.numpy()[tfound])
    np.testing.assert_array_equal(td2[tfound], bd2.numpy()[tfound])
    # the JAX chain, within its rank bound
    assert (jfound == tfound).mean() >= 0.999
    both = jfound & tfound
    ext = float(np.ptp(m[mmask], axis=0).max())
    gap = jd2[both] - td2[both]
    assert gap.min() > -1e-2 and gap.max() < 2.0 * 1.2e-5 * ext**2
    # nn_cell_list on the numpy clouds gives the same answers
    hidx, hd2, hfound = ncl.nn_cell_list(m, mmask, q, qmask, md2, device="cpu")
    np.testing.assert_array_equal(hfound, ofound)
    np.testing.assert_array_equal(hidx[ofound], oidx[ofound])
    np.testing.assert_allclose(hd2[ofound], od2[ofound], rtol=1e-5, atol=1e-4)
    assert nn_cell_list_cuda.cell_list_rows_kernel.launches == launches


def test_nn_cell_list_over_max_cells_answers_through_brute(rng, monkeypatch):
    """A grid over ``max_cells``: no spec fits, so ``nn_cell_list``
    answers through the brute engine, exact against the oracle; without
    the far point the chain answers and the brute engine is not called."""
    m = rng.uniform(0, 100, (600, 3)).astype(np.float32)
    mmask = rng.uniform(size=600) > 0.2
    q = (m[rng.integers(0, 600, 300)] + rng.normal(0, 0.3, (300, 3))).astype(np.float32)
    qmask = rng.uniform(size=300) > 0.1
    calls = []
    brute = tnn.nn_brute_auto

    def spy(*a):
        calls.append(1)
        return brute(*a)

    monkeypatch.setattr(tnn, "nn_brute_auto", spy)
    far = m.copy()
    far[0] = [1e6, 0.0, 0.0]  # ~10^6 cells along x: over 64 million in all
    mmask[0] = True
    for model, want_brute in ((far, True), (m, False)):
        assert (ncl.cell_list_spec([model[mmask], q[qmask]], 1.0, device="cpu") is None) is want_brute
        calls.clear()
        idx, d2, found = ncl.nn_cell_list(model, mmask, q, qmask, 1.0, device="cpu")
        assert bool(calls) is want_brute
        oidx, od2, ofound = _oracle(q, qmask, model, mmask, 1.0)
        assert ofound.sum() > 100
        np.testing.assert_array_equal(found, ofound)
        np.testing.assert_array_equal(idx[ofound], oidx[ofound])
        np.testing.assert_allclose(d2[ofound], od2[ofound], rtol=1e-5, atol=1e-5)
        assert d2.dtype == np.float32 and found.dtype == bool


def _work_items_ref(table, model_rows, item_rows):
    """numpy reference of cell_list_work_items, chunk by chunk."""
    prefix, totals = [0], []
    for row in np.asarray(table, np.int64):
        total = 0
        for r in range(9):
            start = min(max(row[2 + 3 * r] + row[3 + 3 * r], 0), model_rows)
            total += min(max(row[4 + 3 * r], 0), model_rows - start)
        totals.append(total)
        prefix.append(prefix[-1] + -(-total // item_rows))
    return np.asarray(prefix), np.asarray(totals)


@pytest.mark.parametrize("item_rows", [1, 128, 2048])
def test_work_items_match_numpy_on_heavy_tailed_tables(rng, item_rows):
    """Item arithmetic of K2's work split: an empty chunk, a chunk of
    exactly item_rows rows, one of 9 · RB rows, ranges clipped at the
    model's end and negative lengths, among heavy-tailed random chunks."""
    RB, model_rows, W = 4608, 60000, 40
    table = np.zeros((W, 29), np.int32)
    lens = np.minimum(rng.pareto(1.2, (W, 9)) * 200, RB).astype(np.int32)
    starts = rng.integers(0, model_rows - RB, (W, 9)).astype(np.int32)
    table[:, 2::3] = starts // 128 * 128
    table[:, 3::3] = starts % 128
    table[:, 4::3] = lens
    table[0, 4::3] = 0                                     # an empty chunk
    table[1, 4::3] = 0
    table[1, 4] = item_rows                                # exactly one item
    table[2, 4::3] = RB                                    # 9 · RB rows
    table[3, 2], table[3, 3], table[3, 4] = model_rows - 128, 100, 500  # clipped: 28 rows
    table[4, 4] = -7                                       # negative length: none
    table[5, 2], table[5, 4] = model_rows + 256, 50        # starts past the end: none
    prefix, totals = ncl.cell_list_work_items(_t(table), model_rows, item_rows)
    want_prefix, want_totals = _work_items_ref(table, model_rows, item_rows)
    assert prefix.dtype == torch.int64 and prefix.shape == (W + 1,)
    np.testing.assert_array_equal(prefix.numpy(), want_prefix)
    np.testing.assert_array_equal(totals.numpy(), want_totals)
    assert prefix[1] == prefix[0] == 0 and prefix[2] == 1
    assert totals[2] == 9 * RB and prefix[3] - prefix[2] == -(-9 * RB // item_rows)
    # every candidate row of every chunk lies in exactly one item
    n_items = (prefix[1:] - prefix[:-1]).numpy()
    assert ((n_items - 1) * item_rows < want_totals)[want_totals > 0].all()
    assert (n_items * item_rows >= want_totals).all()
    with pytest.raises(ValueError):
        ncl.cell_list_work_items(_t(table), model_rows, 0)


def test_work_items_on_a_planned_table(rng):
    """On a table from the device plan the items cover what the plain K2
    walks: the totals are its per-chunk candidate rows."""
    m, mmask, q, qmask, spec = _overflow_setup(rng)
    _, _, tclm, _ = _build_both(m, mmask, spec, 25.0)
    table = ncl.cell_list_plan_device(
        _t(q), _t(qmask), tclm, dims=spec["dims"], chunk=spec["chunk"],
        perm=tuple(spec["perm"]),
    )[0]
    rows = tclm.model_sorted.shape[0]
    prefix, totals = ncl.cell_list_work_items(table, rows, 64)
    want_prefix, want_totals = _work_items_ref(table.numpy(), rows, 64)
    np.testing.assert_array_equal(prefix.numpy(), want_prefix)
    np.testing.assert_array_equal(totals.numpy(), want_totals)
    np.testing.assert_array_equal(totals.numpy(), table[:, 4::3].sum(1).numpy())
    assert int(prefix[-1]) > table.shape[0]  # chunks are cut into several items


def test_boundary_exclusion():
    """Strict d² < max_dist2 (tests/test_nn_pallas.py:53-60), through
    ``nn_cell_list`` and the chain."""
    m = np.asarray([[10.0, 0.0, 0.0]], np.float32)
    q = np.asarray([[0.0, 0.0, 0.0]], np.float32)
    one = np.ones(1, bool)
    for md2, want in ((100.0, False), (100.01, True)):
        _, d2, found = ncl.nn_cell_list(m, one, q, one, md2, device="cpu")
        assert bool(found[0]) is want and d2[0] == 100.0
        _, _, jfound = npl.nn_cell_list(m, one, q, one, md2)
        assert bool(jfound[0]) is want
        spec = ncl.cell_list_spec([m, q], float(np.sqrt(md2)), device="cpu")
        clm, _ = ncl.build_cell_list_model(
            _t(m), _t(one), spec["origin"], float(np.sqrt(md2)),
            dims=spec["dims"], perm=spec["perm"],
        )
        _, d2, found, oob = ncl.nn_cell_list_chained(
            _t(q), _t(one), clm, md2, dims=spec["dims"],
            chunk=spec["chunk"], perm=spec["perm"],
        )
        assert bool(found[0]) is want and float(d2[0]) == 100.0
        assert int(oob) == 0


def _overflow_setup(rng):
    M, Q = 6000, 2000
    model = rng.uniform(0, 500, (M, 3)).astype(np.float32)
    query = (model[rng.permutation(Q) % M] + rng.normal(0, 3, (Q, 3))).astype(np.float32)
    spec = npl.cell_list_spec(model, 25.0, queries=[query])
    return model, np.ones(M, bool), query, np.ones(Q, bool), spec


def test_query_outside_box_counts_oob(rng):
    m, mmask, q, qmask, spec = _overflow_setup(rng)
    q = q.copy()
    q[:7] += 1e5  # far outside the grid box
    jclm, _, tclm, _ = _build_both(m, mmask, spec, 25.0)
    (_, _, jfound, _, joob), (_, _, tfound, toob) = _chained_both(
        q, qmask, jclm, tclm, spec, 625.0
    )
    assert int(toob) == int(joob) == 7
    assert not tfound[:7].any()
    # a model point outside the box is counted at build time
    m2 = m.copy()
    m2[0] -= 1e5
    _, joobm, _, toobm = _build_both(m2, mmask, spec, 25.0)
    assert toobm == joobm == 1


def test_all_masked_model_and_empty_ranges(rng):
    """No candidate at all: the port answers "not found".  (The JAX
    package maps the kernel's default row 0 to a model point without
    testing its mask, so it can report a masked point as found; see
    ROADMAP queue 3.)"""
    m, _, q, qmask, spec = _overflow_setup(rng)
    q = m[:500].copy()  # queries ON model points: d² = 0 to a masked point
    qmask = np.ones(500, bool)
    none = np.zeros(len(m), bool)
    jclm, _, tclm, _ = _build_both(m, none, spec, 25.0)
    (_, _, jfound, _, _), (_, td2, tfound, toob) = _chained_both(
        q, qmask, jclm, tclm, spec, 625.0
    )
    assert not tfound.any() and int(toob) == 0
    assert np.isfinite(td2).all()
    _, _, hfound = ncl.nn_cell_list(m, none, q, qmask, 625.0, device="cpu")
    assert not hfound.any()
    # one far-away valid point: every range of every chunk is empty
    one = none.copy()
    one[-1] = True
    m2 = m.copy()
    m2[-1] = [480.0, 480.0, 480.0]
    q2 = rng.uniform(0, 100, (300, 3)).astype(np.float32)
    _, _, tclm2, _ = _build_both(m2, one, spec, 25.0)
    rows_before = ncl.cell_list_plan_device(
        _t(q2), _t(np.ones(300, bool)), tclm2, dims=spec["dims"],
        chunk=spec["chunk"], perm=tuple(spec["perm"]),
    )[0]
    assert int(rows_before[:, 4::3].sum()) == 0
    _, _, f2, _ = ncl.nn_cell_list_chained(
        _t(q2), _t(np.ones(300, bool)), tclm2, 625.0, dims=spec["dims"],
        chunk=spec["chunk"], perm=tuple(spec["perm"]),
    )
    assert not f2.any()


def test_plain_k2_contract(rng):
    """cell_list_rows on a hand-made table: rows are start + shift + j,
    the earliest range wins ties, an empty chunk keeps row 0 and +inf."""
    model = torch.full((512, 4), 1e30)
    model[:, 3] = 0
    pts = torch.arange(300, dtype=torch.float32)
    model[:300, 0] = pts
    model[:300, 1:3] = 0
    model[300, :3] = torch.tensor([5.0, 0.0, 0.0])  # a duplicate of row 5
    q = torch.zeros((256, 4))
    q[:128, 0] = torch.arange(128, dtype=torch.float32) + 0.25
    q[128:, 0] = 5.0
    table = torch.zeros((1, 29), dtype=torch.int32)
    table[0, 2:5] = torch.tensor([256, 44, 1])    # range 0: row 300 only
    table[0, 5:8] = torch.tensor([0, 0, 200])     # range 1: rows 0..199
    rows, score = ncl.cell_list_rows(table, q, model, 128 * 2)
    assert rows.dtype == torch.int32 and score.dtype == torch.float32
    np.testing.assert_array_equal(rows[:128].numpy(), np.r_[0:5, 300, 6:128])
    assert (rows[128:] == 300).all() and (score[128:] == 0).all()
    empty = torch.zeros((1, 29), dtype=torch.int32)
    rows, score = ncl.cell_list_rows(empty, q, model, 256)
    assert (rows == 0).all() and torch.isinf(score).all()
    with pytest.raises(ValueError):
        nn_cell_list_cuda.cell_list_rows_kernel(table, q, model, 256)  # CPU tensors


def test_jax_cell_list_state_carries_over(rng):
    """interop: a JAX CellListModel and spec given as numpy give the
    port's chain the same answers as its own build."""
    m, mmask, q, qmask, spec = _overflow_setup(rng)
    jclm, _, tclm, _ = _build_both(m, mmask, spec, 25.0)
    state = {
        "clm": {k: np.asarray(getattr(jclm, k)) for k in jclm._fields},
        "spec": spec,
    }
    scans, params, clm2, spec2 = interop.scans_from_numpy([], None, cell_list=state)
    assert scans == [] and spec2["dims"] == tuple(spec["dims"])
    for k in ("points", "mmask", "model_sorted", "msrc", "cell_start", "origin"):
        assert torch.equal(getattr(clm2, k), getattr(tclm, k)), k
    assert clm2.cell == tclm.cell
    kw = dict(dims=spec2["dims"], chunk=spec2["chunk"], perm=spec2["perm"])
    a = ncl.nn_cell_list_chained(_t(q), _t(qmask), clm2, 625.0, **kw)
    b = ncl.nn_cell_list_chained(_t(q), _t(qmask), tclm, 625.0, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("perm", [(0, 1, 2), (2, 0, 1), (1, 2, 0)])
def test_permute_axes_equals_list_indexing(rng, perm):
    """The plan and the build permute the axes with column views stacked,
    which a CUDA graph can hold: the same tensor as indexing by the list."""
    pts = torch.as_tensor(rng.normal(0, 100, (257, 3)).astype(np.float32))
    got = ncl._permute_axes(pts, perm)
    assert torch.equal(got, pts[:, list(perm)]) and got.is_contiguous()
