"""The chained ICP engine's CUDA graph path against its eager path, on
the card.

Marked ``cuda``: each test skips (at run time) where there is no CUDA
card.  On a machine with one:

    python -m pytest tests/test_torch_icp_chained_graph_cuda.py -q -m cuda --noconftest

A replayed loop trip runs the kernels the eager trip launches (the
query plan, K2, the post, the update), on the same inputs, so the two
paths give the same pose, error, iterations, pairs and guard bit for bit
(``torch.equal``, ``==``)."""

import numpy as np
import pytest
import torch

from tpu3dtk_torch.models import icp as ticp
from tpu3dtk_torch.ops import nn_cell_list as ncl
from tpu3dtk_torch.ops.nn_cell_list_cuda import cell_list_rows_kernel
from tpu3dtk_torch.utils.metrics import CHAINED_GRAPH_REPLAYS, metrics

pytestmark = pytest.mark.cuda

CHAINED_MIN = 98304  # models.sequence's default: the smallest model window the engine takes


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.fixture
def caches(monkeypatch):
    """Both engines' caches, of the module's sizes, starting empty."""
    chained, brute = ticp.GraphCache(ticp._CHAINED_GRAPHS.cap), ticp.GraphCache(ticp._GRAPHS.cap)
    monkeypatch.setattr(ticp, "_CHAINED_GRAPHS", chained)
    monkeypatch.setattr(ticp, "_GRAPHS", brute)
    return chained, brute


def _room(rng, n):
    """n points with 1 cm noise on the floor, ceiling and walls of a
    2000 x 1000 x 600 cm room."""
    face = rng.integers(0, 5, n)
    p = rng.uniform(0, 1, (n, 3)) * [2000.0, 1000.0, 600.0]
    axis = np.array([2, 2, 1, 1, 0])[face]
    at = np.array([0.0, 600.0, 0.0, 1000.0, 0.0])[face]
    p[np.arange(n), axis] = at + rng.normal(0, 1.0, n)
    return p.astype(np.float32)


def _match(dev, Q, M, seed, minimizer="quat", far=False):
    """Arguments of one chained match: a model of M rows and a target of Q
    rows (the last 3% of each masked out), the target 6 cm and ~1 degree
    off, and the spec sized over the model; ``far`` moves a target point
    10^5 cm out of the spec's grid box."""
    rng = np.random.default_rng(seed)
    model, target = _room(rng, M), _room(rng, Q)
    if far:
        target[5] += 1e5
    mmask = np.arange(M) < M - M // 32
    tmask = np.arange(Q) < Q - Q // 32
    c, s = np.cos(0.015), np.sin(0.015)
    T0 = np.array([[c, -s, 0, 4.0], [s, c, 0, -3.0], [0, 0, 1, 3.0], [0, 0, 0, 1]], np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (model, mmask, target, tmask, T0)]
    spec = ncl.cell_list_spec(args[0][args[1]], 50.0)
    assert spec is not None
    return args, dict(max_dist_match2=2500.0, epsilon=1e-6, max_iterations=50,
                      minimizer=minimizer, spec=spec)


def _run(args, kw):
    """icp_pair_chained with the K2 launches, loop trips and replays it added."""
    def counts():
        return (cell_list_rows_kernel.launches, metrics.counters[ticp.CHAINED_TRIPS].total,
                metrics.counters[CHAINED_GRAPH_REPLAYS].total)

    before = counts()
    res = ticp.icp_pair_chained(*args, **kw)
    torch.cuda.synchronize()
    return res, tuple(a - b for a, b in zip(counts(), before))


def _eager(monkeypatch, args, kw):
    with monkeypatch.context() as m:
        m.setattr(ticp, "_chained_graph_path", lambda *a: False)
        return _run(args, kw)


def _assert_same(a, b):
    assert torch.equal(a.T, b.T)
    assert (a.error, a.iterations, a.n_pairs, a.maxocc) == (b.error, b.iterations, b.n_pairs,
                                                            b.maxocc)


@pytest.mark.parametrize("Q,M", [(110592, 110592), (104448, 131072)])
def test_chained_graph_path_equals_eager_path(dev, caches, monkeypatch, Q, M):
    """At chained shapes (model windows above the engine's threshold): a
    key's first match runs eagerly, its second captures (its first trip
    eager, the rest replays), a match of another target on the same key
    replays every trip on the same graph, a new key captures in its
    second match.  Every match equals the eager one, K2's launch count
    rises by the loop trips, and the brute engine's cache stays empty."""
    chained, brute = caches
    assert M >= CHAINED_MIN
    args, kw = _match(dev, Q, M, seed=Q)
    ref, (k2, trips, reps) = _eager(monkeypatch, args, kw)
    assert ref.iterations > 3 and ref.maxocc == 0 and k2 == trips >= ref.iterations and reps == 0

    got, (k2, trips, reps) = _run(args, kw)
    _assert_same(got, ref)
    assert k2 == trips and reps == 0 and not chained.entries

    got, (k2, trips, reps) = _run(args, kw)
    _assert_same(got, ref)
    assert k2 == trips and reps == trips - 1
    (key, captured), = chained.entries.items()
    assert key[:3] == (args[0].device, Q, M) and key[6:] == (50.0, 2500.0, 1e-6, "quat")

    args2, kw2 = _match(dev, Q, M, seed=Q + 1)
    kw2["spec"] = kw["spec"]  # the same grid: the same key
    ref2, _ = _eager(monkeypatch, args2, kw2)
    got2, (k2, trips, reps) = _run(args2, kw2)
    _assert_same(got2, ref2)
    assert k2 == trips == reps and list(chained.entries.values()) == [captured]

    args3, kw3 = _match(dev, Q - 256, M, seed=Q + 2)
    kw3["spec"] = kw["spec"]
    ref3, _ = _eager(monkeypatch, args3, kw3)
    for first in (True, False):
        got3, (k2, trips, reps) = _run(args3, kw3)
        _assert_same(got3, ref3)
        assert k2 == trips and reps == (0 if first else trips - 1)
    assert len(chained.entries) == 2 and chained.entries[key] is captured
    assert not brute.entries and not brute.seen


@pytest.mark.parametrize("minimizer", sorted(ticp.CHAINED_GRAPH_SAFE))
def test_every_chained_graph_safe_minimizer_captures(dev, caches, monkeypatch, minimizer):
    """Each minimizer of CHAINED_GRAPH_SAFE captures without error and
    replays to the eager result."""
    args, kw = _match(dev, 16384, 32768, seed=7, minimizer=minimizer)
    ref, _ = _eager(monkeypatch, args, kw)
    for n in range(3):
        got, (k2, trips, reps) = _run(args, kw)
        _assert_same(got, ref)
        assert k2 == trips and reps == (0, trips - 1, trips)[n]
    assert len(caches[0].entries) == 1


def test_guard_fires_on_the_graph_path(dev, caches, monkeypatch):
    """A target point out of the grid box fires the exactness guard on
    the graph path as on the eager one: ``maxocc`` > 0 after the first
    poll, in the capturing match and in a replaying one."""
    args, kw = _match(dev, 110592, 110592, seed=11, far=True)
    ref, (k2, trips, _) = _eager(monkeypatch, args, kw)
    assert ref.maxocc > 0 and trips == 4 and k2 == 4
    for n in range(3):
        got, (k2, trips, reps) = _run(args, kw)
        _assert_same(got, ref)
        assert k2 == trips == 4 and reps == (0, 3, 4)[n]
