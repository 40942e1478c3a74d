"""K1's CUDA kernel against its plain PyTorch version, on the card.

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
from tpu3dtk_torch.ops import nn_cuda

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
