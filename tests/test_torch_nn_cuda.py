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


def test_kernel_refuses_bad_inputs(dev):
    q = torch.zeros((4, 3), device=dev)
    ok = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        nn_cuda.nn_brute_kernel(q.double(), ok, q, ok, 1.0)
    with pytest.raises(ValueError):
        nn_cuda.nn_brute_kernel(q, ok, q[:, :2].contiguous(), ok, 1.0)
    with pytest.raises(ValueError):
        nn_cuda.nn_brute_kernel(q, ok, q.T.contiguous().T, ok, 1.0)


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
        t[2], t[3], spec["origin"], max_dist, dims=spec["dims"], RB=spec["RB"],
        perm=spec["perm"],
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
    table, q_s, order, _maxlen, oob = ncl.cell_list_plan_device(
        q, qm, clm, dims=spec["dims"], chunk=spec["chunk"], perm=spec["perm"]
    )
    before = nn_cell_list_cuda.cell_list_rows_kernel.launches
    k_rows, k_score = ncl.cell_list_rows_auto(table, q_s, clm.model_sorted, spec["chunk"])
    assert nn_cell_list_cuda.cell_list_rows_kernel.launches == before + 1
    p_rows, p_score = ncl.cell_list_rows(table, q_s, clm.model_sorted, spec["chunk"])
    torch.cuda.synchronize()
    assert torch.equal(k_rows, p_rows)
    assert torch.equal(k_score, p_score)


@pytest.mark.parametrize("rb", [None, 128])
def test_cell_list_chain_matches_brute_kernel(dev, rb):
    """The whole chain (K2, and with rb=128 the overflow lane through K1)
    against K1: both exact, so found is identical and d² equal where the
    same neighbour is chosen; a differing neighbour is an exact or
    rounding-level tie (d² within 1e-2 cm², K1's bound)."""
    (q, qm, m, mm), clm, spec = _cell_list_case(dev, 40000, 20000, 2000.0, 50.0, 0.1, rb)
    idx, d2, found, ovf, oob = ncl.nn_cell_list_chained(
        q, qm, clm, 2500.0, dims=spec["dims"], RB=spec["RB"], chunk=spec["chunk"],
        perm=spec["perm"], cap_over=32768,
    )
    b_idx, b_d2, b_found = tnn.nn_brute_auto(q, qm, m, mm, 2500.0)
    torch.cuda.synchronize()
    assert not bool(ovf) and int(oob) == 0
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
