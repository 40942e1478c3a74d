"""The brute ICP engine's CUDA graph path against its eager path, on the
card.

Marked ``cuda``: each test skips (at run time) where there is no CUDA
card.  On a machine with one:

    python -m pytest tests/test_torch_icp_graph_cuda.py -q -m cuda --noconftest

A replayed iteration runs the kernels the eager iteration launches, on
the same inputs, so the two paths give the same pose, error, iteration
count and pairs bit for bit (``torch.equal``, ``==``)."""

import numpy as np
import pytest
import torch

from tpu3dtk_torch.models import icp as ticp
from tpu3dtk_torch.ops import nn_cuda
from tpu3dtk_torch.utils.metrics import BRUTE_ICP_ITERATIONS, ICP_GRAPH_REPLAYS, metrics

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.fixture
def cache(monkeypatch):
    """A cache of the module's size that starts empty."""
    c = ticp.GraphCache(ticp._GRAPHS.cap)
    monkeypatch.setattr(ticp, "_GRAPHS", c)
    return c


def _room(rng, n):
    """n points with 1 cm noise on the floor, ceiling and walls of a
    2000 x 1000 x 600 cm room, and their unit normals."""
    face = rng.integers(0, 5, n)
    p = rng.uniform(0, 1, (n, 3)) * [2000.0, 1000.0, 600.0]
    nrm = np.zeros((n, 3))
    axis = np.array([2, 2, 1, 1, 0])[face]
    at = np.array([0.0, 600.0, 0.0, 1000.0, 0.0])[face]
    p[np.arange(n), axis] = at + rng.normal(0, 1.0, n)
    nrm[np.arange(n), axis] = 1.0
    return p.astype(np.float32), nrm.astype(np.float32)


def _match(dev, Q, M, seed, minimizer="quat", pairing="closest_point"):
    """Arguments of one match: a model of M rows and a target of Q rows
    (the last 3% of each masked out), the target 6 cm and ~1 degree off."""
    rng = np.random.default_rng(seed)
    model, _ = _room(rng, M)
    target, normals = _room(rng, Q)
    mmask = np.arange(M) < M - M // 32
    tmask = np.arange(Q) < Q - Q // 32
    c, s = np.cos(0.015), np.sin(0.015)
    T0 = np.array([[c, -s, 0, 4.0], [s, c, 0, -3.0], [0, 0, 1, 3.0], [0, 0, 0, 1]], np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (model, mmask, target, tmask, T0)]
    kw = dict(max_dist_match2=2500.0, epsilon=1e-6, max_iterations=50, minimizer=minimizer,
              pairing=pairing)
    if pairing != "closest_point":
        kw["target_normals_local"] = torch.as_tensor(normals, device=dev)
    return args, kw


def _run(args, kw):
    """icp_pair with the K1 launches and both counters it added."""
    before = (nn_cuda.nn_brute_kernel.launches, metrics.counters[BRUTE_ICP_ITERATIONS].total,
              metrics.counters[ICP_GRAPH_REPLAYS].total)
    res = ticp.icp_pair(*args, **kw)
    torch.cuda.synchronize()
    after = (nn_cuda.nn_brute_kernel.launches, metrics.counters[BRUTE_ICP_ITERATIONS].total,
             metrics.counters[ICP_GRAPH_REPLAYS].total)
    return res, tuple(a - b for a, b in zip(after, before))


def _eager(monkeypatch, args, kw):
    with monkeypatch.context() as m:
        m.setattr(ticp, "_graph_path", lambda *a: False)
        return _run(args, kw)


def _assert_same(a, b):
    assert torch.equal(a.T, b.T)
    assert (a.error, a.iterations, a.n_pairs) == (b.error, b.iterations, b.n_pairs)


@pytest.mark.parametrize("Q,M", [(14848, 14848), (44544, 74240)])
def test_graph_path_equals_eager_path(dev, cache, monkeypatch, Q, M):
    """At the sequential match's shape and at the loop-closure window's:
    a shape's first match runs eagerly, its second captures (its first
    iteration eager, the rest replays), a third match of the shape
    replays every iteration on the same graph, a new shape captures in
    its second match.  Every match equals the eager one, and K1's launch
    count rises by the iterations."""
    args, kw = _match(dev, Q, M, seed=Q)
    ref, (k1, its, reps) = _eager(monkeypatch, args, kw)
    assert ref.iterations > 3 and k1 == its == ref.iterations and reps == 0

    got, (k1, its, reps) = _run(args, kw)
    _assert_same(got, ref)
    assert k1 == its == got.iterations and reps == 0 and not cache.entries

    got, (k1, its, reps) = _run(args, kw)
    _assert_same(got, ref)
    assert k1 == its == got.iterations and reps == got.iterations - 1
    assert len(cache.entries) == 1
    (key, captured), = cache.entries.items()
    assert key == (args[0].device, Q, M, 2500.0, "quat", "closest_point")

    args2, kw2 = _match(dev, Q, M, seed=Q + 1)
    ref2, _ = _eager(monkeypatch, args2, kw2)
    got2, (k1, its, reps) = _run(args2, kw2)
    _assert_same(got2, ref2)
    assert k1 == its == reps == got2.iterations
    assert list(cache.entries.values()) == [captured]

    args3, kw3 = _match(dev, Q - 512, M, seed=Q + 2)
    ref3, _ = _eager(monkeypatch, args3, kw3)
    for replayed in (0, ref3.iterations - 1):
        got3, (k1, its, reps) = _run(args3, kw3)
        _assert_same(got3, ref3)
        assert k1 == its == got3.iterations and reps == replayed
    assert len(cache.entries) == 2 and cache.entries[key] is captured


@pytest.mark.parametrize("minimizer,pairing", sorted(ticp.GRAPH_SAFE))
def test_every_graph_safe_pair_captures(dev, cache, monkeypatch, minimizer, pairing):
    """Each minimizer and pairing of GRAPH_SAFE captures without error
    and replays to the eager result."""
    args, kw = _match(dev, 4096, 8192, seed=7, minimizer=minimizer, pairing=pairing)
    ref, _ = _eager(monkeypatch, args, kw)
    for replayed in (0, ref.iterations - 1, ref.iterations):
        got, (k1, its, reps) = _run(args, kw)
        _assert_same(got, ref)
        assert k1 == its == got.iterations and reps == replayed
    assert len(cache.entries) == 1


def test_capture_while_another_thread_uses_the_card(dev, cache, monkeypatch):
    """A capture leaves other threads the card: streaming's prefetch
    workers reduce scans there (uploads, ``nonzero``, copies to the
    host, new allocations) while the main thread matches.  With such a
    thread running throughout, matches of new shapes capture and replay
    to the eager results, and the thread meets no error."""
    import threading

    from tpu3dtk_torch.ops.reduction import reduce_scan

    shapes = [(6144 - 512 * k, 8192 + 512 * k) for k in range(6)]
    cases = [_match(dev, Q, M, seed=100 + Q) for Q, M in shapes]
    refs = [_eager(monkeypatch, args, kw)[0] for args, kw in cases]
    cloud = np.random.default_rng(3).uniform(-5000, 5000, (200_000, 3)).astype(np.float32)
    stop, errors, reductions = threading.Event(), [], [0]

    def reduce_on_the_card():
        try:
            while not stop.is_set():
                reduce_scan(cloud, 10.0, 1, device=dev)
                reductions[0] += 1
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    worker = threading.Thread(target=reduce_on_the_card)
    worker.start()
    try:
        for (args, kw), ref in zip(cases, refs):
            for replayed in (0, ref.iterations - 1, ref.iterations):
                got, (k1, its, reps) = _run(args, kw)
                _assert_same(got, ref)
                assert k1 == its == got.iterations and reps == replayed
    finally:
        stop.set()
        worker.join()
    assert not errors and reductions[0] > 0
    assert len(cache.entries) == len(shapes)
