"""BaryonifySnapshot past one chunk of pairs, on the CPU: the plain version
of the card's cell list (K24, ops.snapshot.cell_query_plain) against the
host searches, the chunk planner on counts past 2^31 (a halo of more pairs
than the budget cut across chunks), and the runner with its PAIR_BUDGET
cut to a few hundred pairs, or under its largest halo's pairs, against its
one-chunk run and the JAX runner.

Tolerances: the neighbour sets equal, halo for halo; the wrap bitwise
np.mod's; a run in chunks bitwise the one-chunk run (each chunk's sums go
on from the chunks before, in ascending halo order); against the JAX runner
(one size bucket), tests/test_torch_snapshot.py's: float32 to
tests/test_snapshot.py:67 (atol 5e-4, rtol 1e-3), float64 to 1e-10 of the
largest displacement.
"""

import numpy as np
import pytest
from scipy.spatial import cKDTree

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

from baryonforge_tpu import utils as JUtils                 # noqa: E402
from baryonforge_tpu.Runners.SnapshotRunner import \
    BaryonifySnapshot as JSnapshot                          # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch import native, parallel              # noqa: E402
from baryonforge_torch.ops import snapshot as tsnap         # noqa: E402
from baryonforge_torch.Runners import SnapshotRunner        # noqa: E402

from test_torch_snapshot import (BOXES, JDT, TDT, _box, _close,  # noqa: E402
                                 _moves, _objects, models)
from test_torch_direct_snapshot import HideCurves           # noqa: E402

# pairs a chunk: the boxes' 1,000-2,000 pairs take 4 chunks or more
BUDGET = 300


def _sets(counts, parts):
    """Each halo's particles as a sorted list."""
    off = np.concatenate([[0], np.cumsum(counts)])
    return [sorted(parts[a:b].tolist()) for a, b in zip(off, off[1:])]


def test_wrap_plain_is_np_mod():
    L = 128.0
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-3 * L, 3 * L, 4000),
                        [-1e-17, -0.0, 0.0, L, -L, 2 * L, L - 1e-13,
                         -L + 1e-13, 5e-324, -5e-324]])
    got = tsnap.wrap_plain(torch.as_tensor(x), L).numpy()
    np.testing.assert_array_equal(got.view(np.int64),
                                  np.mod(x, L).view(np.int64))


@pytest.mark.parametrize("radius", [10.0, 20.0, 30.0, 35.0, 46.0])
def test_cell_query_plain_equals_host_cell_list(radius):
    """3D, tests/test_torch_snapshot.py's radii 10 to 46 (the window wraps
    at 35 and 46), particles also outside the box: the plain version's
    sets are native.cell_query's."""
    rng = np.random.default_rng(int(radius) + 100)
    L = 128.0
    pos = rng.uniform(-0.2 * L, 1.2 * L, (4000, 3))
    centers = rng.uniform(0, L, (40, 3))
    radii = rng.uniform(0.2, 1.0, 40) * radius
    radii[0] = radius
    radii[1] = 0.0
    counts, idx = native.cell_query(pos, L, centers, radii)
    got = tsnap.cell_query_plain(torch.as_tensor(pos), L,
                                 torch.as_tensor(centers),
                                 torch.as_tensor(radii), block=1 << 16)
    assert got[0].tolist() == counts.tolist()
    assert got[1][-1] == counts.sum()
    assert _sets(counts, got[2].numpy()) == _sets(counts, idx)


@pytest.mark.parametrize("radius", [8.0, 40.0, 60.0])
def test_cell_query_plain_equals_ckdtree_2d(radius):
    """2D: the plain version's sets are cKDTree's (the CPU runner's 2D
    search, on the positions wrapped as np.mod)."""
    rng = np.random.default_rng(int(radius))
    L = 96.0
    pos = rng.uniform(-10, L + 10, (3000, 2))
    centers = rng.uniform(0, L, (30, 2))
    radii = rng.uniform(0.2, 1.0, 30) * radius
    lists = cKDTree(np.mod(pos, L), boxsize=L).query_ball_point(
        np.mod(centers, L), radii)
    counts, _, parts = tsnap.cell_query_plain(
        torch.as_tensor(pos), L, torch.as_tensor(centers),
        torch.as_tensor(radii))
    assert counts.tolist() == [len(x) for x in lists]
    assert _sets(counts.numpy(), parts.numpy()) == [sorted(x) for x in lists]


def test_pair_chunks_past_int32():
    """40,000 halos of 10^2-10^5 pairs and a few of more than the budget,
    2.6 x 10^9 pairs in all (int64 counts only): every chunk within the
    budget; the chunks cover every halo's pairs once, in order, each halo
    in one run of chunks; a halo of more pairs than the budget cut into
    runs of its own pairs, the budget each and the rest last; a chunk of
    whole halos could not have taken its next halo."""
    rng = np.random.default_rng(19)
    counts = (10 ** rng.uniform(2, 5, 40000)).astype(np.int64)
    counts[rng.integers(0, counts.size, 300)] = 0
    counts[[7, 8, 20000, 39999]] = [3 << 28, 1 << 28, 5 << 27, 1 << 29]
    budget = 1 << 28
    assert counts.sum() > np.iinfo(np.int32).max
    chunks = tsnap.pair_chunks(counts, budget)
    bounds = np.array(chunks, dtype=np.int64)
    h0, h1, p0, p1 = bounds.T
    cum = np.concatenate([[0], np.cumsum(counts)])
    assert np.all(p1 - p0 <= budget) and np.all(p1 > p0)
    # the pairs once, in order, and each chunk's pairs its halos' own
    assert p0[0] == 0 and p1[-1] == cum[-1]
    np.testing.assert_array_equal(p0[1:], p1[:-1])
    assert np.all(cum[h0] <= p0) and np.all(p1 <= cum[h1])
    # the halos in order: a chunk starts where the last one ended, or on
    # the same halo when that halo is cut across both
    assert h0[0] == 0 and h1[-1] == counts.size
    cut = h1 - h0 == 1
    same = (h0[1:] == h0[:-1]) & cut[1:] & cut[:-1]
    np.testing.assert_array_equal(h0[1:][~same], h1[:-1][~same])
    big = np.flatnonzero(counts > budget)
    for h in big:
        mine = (h0 == h) & cut
        np.testing.assert_array_equal(p1[mine] - p0[mine], (
            [budget] * int(counts[h] // budget)
            + ([int(counts[h] % budget)] if counts[h] % budget else [])))
    assert np.all(~cut | (p0 == cum[h0]) | np.isin(h0, big))
    # a run of whole halos could not have taken its next halo
    whole = ~np.isin(h0, big) & (h1 < counts.size)
    assert np.all(cum[h1[whole] + 1] - p0[whole] > budget)
    assert tsnap.pair_chunks(np.zeros(0, np.int64), budget) == []
    assert tsnap.pair_chunks(np.array([0, 5, 0]), 2) == [
        (0, 1, 0, 0), (1, 2, 0, 2), (1, 2, 2, 4), (1, 2, 4, 5),
        (2, 3, 5, 5)]


def _runner(ndim, dt, direct, tm, **kw):
    _, L, n, nh, logM, seed = BOXES[ndim]
    pos, hpos, M = _box(ndim, L, n, nh, logM, seed)
    model = HideCurves(tm) if direct else tm
    return bf.BaryonifySnapshot(*_objects(bf.utils, ndim, L, pos, hpos, M),
                                epsilon_max=20, model=model, dtype=TDT[dt],
                                verbose=False, device="cpu", **kw)


def _out(out, ndim):
    return np.stack([np.asarray(out[c]) for c in "xyz"[:ndim]])


@pytest.mark.parametrize("cut", ["budget", "largest"])
@pytest.mark.parametrize("direct", [False, True], ids=["curve", "direct"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("ndim", [3, 2])
def test_chunked_runner_equals_one_chunk(models, monkeypatch, ndim, dt,
                                         direct, cut):
    """The runner in 4 chunks or more, bit for bit its one-chunk run, and
    close to the JAX runner. ``cut`` "budget": BUDGET pairs a chunk (the
    2D box's largest halos hold more, and are cut across chunks);
    "largest": a third of the largest halo's pairs, so that halo is cut
    into three chunks or more of its own pairs."""
    jm, tm = models[ndim]
    whole = _runner(ndim, dt, direct, tm)
    one = _out(whole.process(), ndim)
    counts = np.diff(whole._pairs[1])
    budget = BUDGET if cut == "budget" else int(counts.max()) // 3
    bounds = tsnap.pair_chunks(counts, budget)
    assert max(c[3] - c[2] for c in bounds) <= budget
    big = int(np.argmax(counts))
    assert (sum(c[:2] == (big, big + 1) for c in bounds) >= 3) == (
        cut == "largest")
    monkeypatch.setattr(SnapshotRunner, "PAIR_BUDGET", budget)
    runner = _runner(ndim, dt, direct, tm)
    got = runner.process()
    n_chunks = len(runner._shard_chunks(1)[0])
    assert n_chunks >= 4
    np.testing.assert_array_equal(_out(got, ndim), one)
    # a second call on the kept chunks, the same bits
    np.testing.assert_array_equal(_out(runner.process(), ndim), one)

    _, L, n, nh, logM, seed = BOXES[ndim]
    pos, hpos, M = _box(ndim, L, n, nh, logM, seed)
    jcat, jsnap = _objects(JUtils, ndim, L, pos, hpos, M)
    want = _moves(JSnapshot(jcat, jsnap, epsilon_max=20,
                            model=HideCurves(jm) if direct else jm,
                            verbose=False, dtype=JDT[dt],
                            n_size_buckets=1).process(), pos, L)
    assert np.abs(want).max() > 0.05
    _close(_moves(got, pos, L), want, dt)


@pytest.mark.parametrize("ndim", [3, 2])
def test_chunked_mesh_and_rebuilt_chunks(models, monkeypatch, ndim):
    """halo_mesh(2, "cpu") in chunks equals the mesh's one-chunk run bit
    for bit; chunks made anew each call (over PAIR_CACHE_BYTES) equal kept
    ones and are not kept."""
    _, tm = models[ndim]
    mesh = parallel.halo_mesh(2, "cpu")
    one = _out(_runner(ndim, "f32", False, tm, mesh=mesh).process(), ndim)
    monkeypatch.setattr(SnapshotRunner, "PAIR_BUDGET", BUDGET)
    runner = _runner(ndim, "f32", False, tm, mesh=mesh)
    np.testing.assert_array_equal(_out(runner.process(), ndim), one)
    shards = runner._pairs[3][2][1]
    assert len(shards) == 2 and min(len(s) for s in shards) >= 2
    kept = _out(_runner(ndim, "f64", False, tm).process(), ndim)
    monkeypatch.setattr(SnapshotRunner, "PAIR_CACHE_BYTES", 0)
    runner = _runner(ndim, "f64", False, tm)
    for _ in range(2):
        np.testing.assert_array_equal(_out(runner.process(), ndim), kept)
    assert runner._pairs[3] == {}
