"""The CUDA kernels (K1 brute NN, K2 cell-list NN) against their plain
PyTorch versions, on the card.

Marked ``cuda``: each test skips (at run time) where there is no CUDA
card.  On a machine with one:

    python -m pytest tests/test_torch_nn_cuda.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py imports JAX, which a machine set
up for the port alone does not have.)

Both versions round the same f32 operations in the same order, so on
identical inputs they choose the same indices; the bounds below are the
contract (index agreement >= 0.999, chosen d² within 1e-2 cm²)."""

import numpy as np
import pytest
import torch

from tpu3dtk_torch.ops import nn as tnn
from tpu3dtk_torch.ops import nn_cell_list as ncl
from tpu3dtk_torch.ops import nn_cell_list_cuda, nn_cuda

from helpers.clouds import DeviceOps, city_cloud

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "Q,M,masked", [(16384, 16384, 0.0), (1000, 70001, 0.1), (1, 1, 0.0), (130, 5, 0.5)]
)
def test_kernel_matches_plain(dev, Q, M, masked):
    rng = np.random.default_rng(Q + M)
    m = rng.uniform(-2000, 2000, (M, 3)).astype(np.float32)
    q = (m[rng.integers(0, M, Q)] + rng.normal(0, 20, (Q, 3))).astype(np.float32)
    mm = rng.uniform(size=M) >= masked
    mm[0] = True
    args = [torch.as_tensor(a, device=dev) for a in (q, np.ones(Q, bool), m, mm)]
    before = nn_cuda.nn_brute_kernel.launches
    k_idx, k_d2, k_found = tnn.nn_brute_auto(*args, 2500.0)
    assert nn_cuda.nn_brute_kernel.launches == before + 1
    p_idx, p_d2, p_found = tnn.nn_brute(*args, 2500.0)
    torch.cuda.synchronize()
    assert (k_idx == p_idx).double().mean().item() >= 0.999
    assert (k_d2 - p_d2).abs().max().item() <= 1e-2
    assert torch.equal(k_found, p_found)


@pytest.mark.parametrize(
    "Q,M,masked", [(14848, 14848, 0.03), (1000, 70001, 0.1), (513, 17, 1.0), (3, 1, 0.0)]
)
def test_prepared_kernel_matches_plain_and_bare(dev, Q, M, masked):
    """K1 through a model prepared once: the answers of the bare call and
    of the plain version on the same prepared model (masked=1.0: every
    model point masked, index 0 and not found)."""
    rng = np.random.default_rng(Q * 7 + M)
    m = rng.uniform(-2000, 2000, (M, 3)).astype(np.float32)
    q = (m[rng.integers(0, M, Q)] + rng.normal(0, 20, (Q, 3))).astype(np.float32)
    mm = rng.uniform(size=M) >= masked
    qm = rng.uniform(size=Q) >= 0.05
    q, qm, m, mm = (torch.as_tensor(a, device=dev) for a in (q, qm, m, mm))
    bm = tnn.prepare_brute_model(m, mm)
    before = nn_cuda.nn_brute_kernel.launches
    k = tnn.nn_brute_auto(q, qm, bm, None, 2500.0)
    b = tnn.nn_brute_auto(q, qm, m, mm, 2500.0)
    assert nn_cuda.nn_brute_kernel.launches == before + 2
    p = tnn.nn_brute(q, qm, bm, None, 2500.0)
    torch.cuda.synchronize()
    for x, y in zip(k, b):
        assert torch.equal(x, y)
    assert k[0].dtype == torch.int64 and k[2].dtype == torch.bool
    assert (k[0] == p[0]).double().mean().item() >= 0.999
    assert (k[1] - p[1]).abs().max().item() <= 1e-2
    assert torch.equal(k[2], p[2])
    if masked == 1.0:
        assert not bool(k[0].any()) and not bool(k[2].any())
        assert bool((k[1] == tnn.BIG).all())


def _nn_without_prepare(q, qm, m, mm, max_dist2):
    """Brute NN that shares nothing with ``prepare_brute_model``: its own
    masked mean, the mask as an added 0 / +inf, the gate written out."""
    w = mm.to(torch.float32)[:, None]
    c = (m * w).sum(0) / torch.clamp(w.sum(), min=1.0)
    d = (q - c)[:, None, :] - (m - c)[None, :, :]
    score = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    idx = torch.argmin(score + torch.where(mm, 0.0, float("inf")), dim=1)
    e = q - m[idx]
    d2 = torch.where(mm[idx], e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2], tnn.BIG)
    return idx, d2, qm & mm[idx] & (d2 < max_dist2)


@pytest.mark.parametrize("Q,M,masked", [(4096, 14848, 0.03), (513, 17, 1.0), (700, 5000, 0.6)])
def test_kernel_matches_a_reference_that_prepares_nothing(dev, Q, M, masked):
    """The plain version ranks the tensors ``prepare_brute_model`` built,
    which the kernel reads too, so a wrong centre, a flipped mask or a bad
    +inf pack would pass kernel-against-plain.  Here the kernel (prepared
    and bare) and the plain version meet a ranking built from the raw model
    and mask: the same operations on the same values, so equal indices are
    expected, and the kernel's contract bounds are what is asserted."""
    rng = np.random.default_rng(Q * 3 + M)
    m = rng.uniform(500, 4500, (M, 3)).astype(np.float32)  # off-centre: the centre matters
    q = (m[rng.integers(0, M, Q)] + rng.normal(0, 20, (Q, 3))).astype(np.float32)
    mm = rng.uniform(size=M) >= masked
    qm = rng.uniform(size=Q) >= 0.05
    q, qm, m, mm = (torch.as_tensor(a, device=dev) for a in (q, qm, m, mm))
    r_idx, r_d2, r_found = _nn_without_prepare(q, qm, m, mm, 2500.0)
    bm = tnn.prepare_brute_model(m, mm)
    for got in (
        tnn.nn_brute_auto(q, qm, bm, None, 2500.0),
        tnn.nn_brute_auto(q, qm, m, mm, 2500.0),
        tnn.nn_brute(q, qm, m, mm, 2500.0),
    ):
        torch.cuda.synchronize()
        assert (got[0] == r_idx).double().mean().item() >= 0.999
        assert (got[1] - r_d2).abs().max().item() <= 1e-2
        assert torch.equal(got[2], r_found)


@pytest.mark.parametrize("first,last,n_real", [(0, 9, 10), (1, 8, 9), (4, 11, 12)])
def test_kernel_at_the_loop_closure_window_shape(dev, first, last, n_real):
    """K1 as the ELCH loop ICP calls it: a model window of 5 whole scans
    (74240 points) against a target window of 3 (44544 queries) built by
    ``icp._window_build`` from resident [S, 14848, 3] tensors, with whole
    scans masked out (first < 2: two of the five; scans >= n_real) and a
    clipped window start.  Prepared and bare, against the plain version
    and against a ranking built from the raw model and mask."""
    from tpu3dtk_torch.models import icp as icp_mod

    S, N = 12, 14848
    rng = np.random.default_rng(first * 31 + last)
    base = rng.uniform(-600, 600, (N, 3)).astype(np.float32)
    locals_all = np.stack([base + rng.normal(0, 2.0, (N, 3)).astype(np.float32) for _ in range(S)])
    masks_all = rng.uniform(size=(S, N)) >= 0.03
    mats = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    mats[:, 0, 3] = 40.0 * np.arange(S)
    mats[last - 2:, 2, 3] += 15.0  # the end window has drifted
    model, mmask, tgt, tmask = icp_mod._window_build(
        *(torch.as_tensor(a, device=dev) for a in (locals_all, masks_all, mats)),
        first - 2, first + 2, last - 2, last, n_real, wm=5, wt=3)
    model, tgt = model.contiguous(), tgt.contiguous()
    assert model.shape == (5 * N, 3) and tgt.shape == (3 * N, 3)
    live = mmask.reshape(5, N).any(1).sum().item()
    assert live == min(first + 2, n_real - 1) - max(first - 2, 0) + 1
    md2 = 2500.0
    r_idx = torch.empty(3 * N, dtype=torch.int64, device=dev)
    w = mmask.to(torch.float32)[:, None]
    c = (model * w).sum(0) / torch.clamp(w.sum(), min=1.0)
    minf = torch.where(mmask, 0.0, float("inf"))
    mc = (model - c).T.contiguous()
    for s0 in range(0, 3 * N, 256):
        d = [(tgt[s0:s0 + 256, k:k + 1] - c[k]) - mc[k] for k in range(3)]
        r_idx[s0:s0 + 256] = torch.argmin(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + minf, dim=1)
    e = tgt - model[r_idx]
    r_d2 = e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2]
    r_found = tmask & mmask[r_idx] & (r_d2 < md2)
    assert 0 < int(r_found.sum()) < int(tmask.sum())
    bm = tnn.prepare_brute_model(model, mmask)
    before = nn_cuda.nn_brute_kernel.launches
    k = tnn.nn_brute_auto(tgt, tmask, bm, None, md2)
    b = tnn.nn_brute_auto(tgt, tmask, model, mmask, md2)
    assert nn_cuda.nn_brute_kernel.launches == before + 2
    p = tnn.nn_brute(tgt, tmask, bm, None, md2)
    torch.cuda.synchronize()
    for x, y in zip(k, b):
        assert torch.equal(x, y)
    for ref in (p, (r_idx, r_d2, r_found)):
        assert (k[0] == ref[0]).double().mean().item() >= 0.999
        assert (k[1] - ref[1]).abs().max().item() <= 1e-2
        assert torch.equal(k[2], ref[2])
    assert bool(mmask[k[0]].all())  # no winner from a masked-out scan


def test_kernel_refuses_bad_inputs(dev):
    q = torch.zeros((4, 3), device=dev)
    ok = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        nn_cuda.nn_brute_kernel(q.double(), ok, q, ok, 1.0)
    with pytest.raises(ValueError):
        nn_cuda.nn_brute_kernel(q, ok, q[:, :2].contiguous(), ok, 1.0)
    with pytest.raises(ValueError):
        nn_cuda.nn_brute_kernel(q, ok, q.T.contiguous().T, ok, 1.0)


def test_kernel_refuses_bad_prepared_model(dev):
    """Every field of a BruteModel is checked: device, dtype, shape,
    contiguity; and a prepared model takes no second mask."""
    q = torch.zeros((4, 3), device=dev)
    ok = torch.ones(4, dtype=torch.bool, device=dev)
    bm = tnn.prepare_brute_model(q, ok)
    nn_cuda.nn_brute_kernel(q, ok, bm, None, 1.0)
    wide = torch.zeros((4, 8), device=dev)
    bad = [
        (bm._replace(center=bm.center.cpu()), ValueError),
        (bm._replace(center=bm.center.double()), TypeError),
        (bm._replace(center=torch.zeros(4, device=dev)), ValueError),
        (bm._replace(center=torch.zeros(6, device=dev)[::2]), ValueError),
        (bm._replace(packed=bm.packed.cpu()), ValueError),
        (bm._replace(packed=bm.packed.half()), TypeError),
        (bm._replace(packed=bm.packed[:, :3].contiguous()), ValueError),
        (bm._replace(packed=bm.packed[:3].contiguous()), ValueError),
        (bm._replace(packed=wide[:, ::2]), ValueError),
        (bm._replace(model=bm.model.cpu()), ValueError),
        (bm._replace(mmask=bm.mmask.to(torch.uint8)), TypeError),
        (bm._replace(mmask=bm.mmask[:3].contiguous()), ValueError),
    ]
    for model, exc in bad:
        with pytest.raises(exc):
            nn_cuda.nn_brute_kernel(q, ok, model, None, 1.0)
    with pytest.raises(ValueError):
        nn_cuda.nn_brute_kernel(q, ok, bm, ok, 1.0)


def _cell_list_case(dev, M, Q, extent, max_dist, masked, rb=None):
    rng = np.random.default_rng(M + Q)
    m = rng.uniform(0, extent, (M, 3)).astype(np.float32)
    q = (m[rng.integers(0, M, Q)] + rng.normal(0, max_dist / 5, (Q, 3))).astype(np.float32)
    mm = rng.uniform(size=M) >= masked
    spec = ncl.cell_list_spec(m[mm], max_dist, queries=[q])
    assert spec is not None
    if rb is not None:
        spec = dict(spec, RB=rb)
    t = [torch.as_tensor(a, device=dev) for a in (q, np.ones(Q, bool), m, mm)]
    clm, oob = ncl.build_cell_list_model(
        t[2], t[3], spec["origin"], max_dist, dims=spec["dims"], perm=spec["perm"],
    )
    assert int(oob) == 0
    return t, clm, spec


@pytest.mark.parametrize(
    "M,Q,extent,max_dist,masked",
    [(60000, 50000, 3000.0, 50.0, 0.0), (20000, 7001, 800.0, 25.0, 0.2),
     (300, 100, 100.0, 25.0, 0.0)],
)
def test_cell_list_kernel_matches_plain(dev, M, Q, extent, max_dist, masked):
    """K2 and its plain version round the same f32 operations in the
    same order: identical rows and scores."""
    (q, qm, m, mm), clm, spec = _cell_list_case(dev, M, Q, extent, max_dist, masked)
    table, q_s, order, oob = ncl.cell_list_plan_device(
        q, qm, clm, dims=spec["dims"], chunk=spec["chunk"], perm=spec["perm"]
    )
    before = nn_cell_list_cuda.cell_list_rows_kernel.launches
    k_rows, k_score = ncl.cell_list_rows_auto(table, q_s, clm.model_sorted, spec["chunk"])
    assert nn_cell_list_cuda.cell_list_rows_kernel.launches == before + 1
    p_rows, p_score = ncl.cell_list_rows(table, q_s, clm.model_sorted, spec["chunk"])
    torch.cuda.synchronize()
    assert torch.equal(k_rows, p_rows)
    assert torch.equal(k_score, p_score)
    # other item sizes and grids (one row an item, items that
    # end inside a range, one item a chunk): the same rows again, and the
    # item prefix the init kernel computes equal to its plain version
    W, T, Mrows = table.shape[0], spec["chunk"], clm.model_sorted.shape[0]
    for item_rows, blocks in ((1, 132), (100, 2112), (4096, 16), (2**20, 1056)):
        scratch = torch.empty(W * T + W + 2, dtype=torch.int64, device=dev)
        rows, score = torch.empty_like(p_rows), torch.empty_like(p_score)
        nn_cell_list_cuda._launch(
            table, q_s, clm.model_sorted, T, item_rows, blocks, scratch, rows, score
        )
        assert torch.equal(rows, p_rows) and torch.equal(score, p_score)
        prefix, _totals = ncl.cell_list_work_items(table, Mrows, item_rows)
        assert torch.equal(scratch[W * T + 1:], prefix)


@pytest.mark.parametrize("rb", [None, 128])
def test_cell_list_chain_matches_brute_kernel(dev, rb):
    """The chain the engines run (K2 on the table as planned) against K1,
    on the spec as sized and on one whose RB is 128 (which limits
    nothing in the port): both exact, so found is identical and d² equal
    where the same neighbour is chosen; a differing neighbour is an exact
    or rounding-level tie (d² within 1e-2 cm², K1's bound)."""
    (q, qm, m, mm), clm, spec = _cell_list_case(dev, 40000, 20000, 2000.0, 50.0, 0.1, rb)
    idx, d2, found, oob = ncl.nn_cell_list_chained(
        q, qm, clm, 2500.0, dims=spec["dims"], chunk=spec["chunk"], perm=spec["perm"],
    )
    b_idx, b_d2, b_found = tnn.nn_brute_auto(q, qm, m, mm, 2500.0)
    torch.cuda.synchronize()
    assert int(oob) == 0
    assert torch.equal(found, b_found)
    assert (idx[found] == b_idx[found]).double().mean().item() >= 0.999
    assert (d2[found] - b_d2[found]).abs().max().item() <= 1e-2


def test_cell_list_kernel_refuses_bad_inputs(dev):
    table = torch.zeros((2, 29), dtype=torch.int32, device=dev)
    q = torch.zeros((512, 4), device=dev)
    m = torch.zeros((1024, 4), device=dev)
    nn_cell_list_cuda.cell_list_rows_kernel(table, q, m, 256)
    with pytest.raises(TypeError):
        nn_cell_list_cuda.cell_list_rows_kernel(table.long(), q, m, 256)
    with pytest.raises(ValueError):
        nn_cell_list_cuda.cell_list_rows_kernel(table, q[:500], m, 256)
    with pytest.raises(ValueError):
        nn_cell_list_cuda.cell_list_rows_kernel(table, q, m[:, :3].contiguous(), 256)
    with pytest.raises(ValueError):
        nn_cell_list_cuda.cell_list_rows_kernel(table, q, m, 64)
    with pytest.raises(ValueError):
        nn_cell_list_cuda.cell_list_rows_kernel(table.cpu(), q.cpu(), m.cpu(), 256)


def test_cell_list_spec_on_the_card_equals_the_cpu(dev):
    """The spec on CUDA tensors, and on numpy clouds with
    ``device="cuda"``, equals the spec on CPU tensors: on city clouds, and
    on the same clouds snapped onto cell faces, where a product by the
    reciprocal of the cell edge would bin points one cell low.  On the
    card it reads the device at most twice."""
    rng = np.random.default_rng(7)
    cell = 150.0
    clouds = [city_cloud(rng, 20000) + np.float32(5 * k) for k in range(4)]
    faces = [(np.round(c / cell) * cell).astype(np.float32) for c in clouds]
    kw = dict(headroom=2.0, pairs=[(0, 1), (1, 2), (2, 3), (0, 3)])
    for numpy_sets in (clouds, faces):
        cpu = [torch.as_tensor(c) for c in numpy_sets]
        want = ncl.cell_list_spec(cpu, cell, model_sets=cpu, queries=cpu, **kw)
        assert want is not None
        card = [c.to(dev) for c in cpu]
        with DeviceOps() as ops:
            got = ncl.cell_list_spec(card, cell, model_sets=card, queries=card, **kw)
        assert ops.cuda_reads <= 2
        from_numpy = ncl.cell_list_spec(
            numpy_sets, cell, model_sets=numpy_sets, queries=numpy_sets, device="cuda", **kw
        )
        for spec in (got, from_numpy):
            assert set(spec) == set(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(spec[k]), np.asarray(want[k]))
