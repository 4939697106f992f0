"""The layouts of kernels K17 (the snapshot displacement, a per-particle
gather) and K16 (the grid deposit through tile windows), checked on the CPU
against their reference plain versions and the JAX package.

K17 reads the halo-major pairs particle-major: ``ops.snapshot.
particle_major_plain`` must be a stable sort of the pairs by their
particle's place in the space-filling order, and ``snapshot_gather_plain``
(each particle's rows summed in that order) must give what the halo-major
reference ``snapshot_displace_plain`` gives: float64 to 1e-14 of the
largest offset (on these inputs it is bitwise: both sum a particle's rows
from 0 in ascending row order, and the per-pair arithmetic is the same),
float32 to tests/test_snapshot.py:67 (atol 5e-4, rtol 1e-3). On the small
boxes of tests/test_torch_snapshot.py (largest query radius at most L / 3,
clear of the JAX cell list's double count) the gather goes against the JAX
``BaryonifySnapshot``: float64 to 1e-10 of the largest displacement,
float32 to tests/test_snapshot.py:67.

K16 sums a tile of sources into a window grown by a cell on each side,
spills what leaves it into the map and flushes the window:
``ops.scatter.grid_deposit_windows_plain`` must equal
``grid_deposit_plain`` and the JAX ``deposit_2d`` / ``deposit_3d`` to 1e-12
of the largest value in float64 (1e-5 in float32: the 2^d-term sums in
another order), and conserve mass to 1e-12 in float64, on grids that are
no multiple of the tile, with offsets inside the window and up to 5 cells,
non-finite offsets, sources at every face and a non-finite value.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu.ops import scatter as jscatter         # noqa: E402
from baryonforge_tpu.Runners.SnapshotRunner import \
    BaryonifySnapshot as JSnapshot                          # noqa: E402
from baryonforge_tpu import utils as JUtils                 # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import scatter as tscatter       # noqa: E402
from baryonforge_torch.ops import snapshot as tsnap         # noqa: E402
from baryonforge_torch.ops.tiles import pairs_csr           # noqa: E402
from baryonforge_torch.Runners.HealpixRunner import \
    _PhaseClock                                             # noqa: E402

from test_torch_snapshot import (BOXES, JDT, TDT, _box, _close,  # noqa
                                 _moves, _objects, _query_radii,
                                 models)


# -- K17: the particle-major layout and the gather ---------------------------
def _pairs(ndim, dt, seed, n=300, nh=12, n_r=24, L=40.0):
    """Random pairs (halo-major, as pairs_csr groups them) with particles
    that have no pair, halos without rows, a particle at its halo's centre
    and a NaN in a curve; the arguments of snapshot_displace."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, L + 0.5, (n, ndim))
    hpos = rng.uniform(0, L, (nh, ndim))
    counts = rng.integers(0, 50, nh)
    counts[[2, 7]] = 0
    pool = np.arange(n - 40)            # the last 40 particles: no pairs
    parts = np.concatenate([rng.choice(pool, c, replace=False)
                            for c in counts])
    owner = np.repeat(np.arange(nh), counts)
    pos[parts[0]] = hpos[owner[0]]
    curves = rng.normal(size=(nh, n_r))
    curves[1, 4] = np.nan
    halos, offsets, tparts = (torch.as_tensor(x) for x in
                              pairs_csr(owner.astype(np.int32), parts))
    T = lambda x: torch.as_tensor(x).to(dt)
    return (torch.as_tensor(pos), torch.as_tensor(hpos), halos, offsets,
            tparts, T(curves), float(np.log(0.05)),
            float(np.log(80 / 0.05) / (n_r - 1)), T(rng.uniform(0.5, 2, nh)),
            T(rng.uniform(5, 30, nh)), L)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_particle_major_is_a_stable_sort(ndim, seed):
    """(poff, prow) equal a numpy stable argsort of the halo-major pairs by
    their particle's place in the order; the order is a permutation that
    sorts the particles' Morton keys."""
    args = _pairs(ndim, torch.float64, seed)
    coords, _, halos, offsets, parts = args[:5]
    L = args[-1]
    order, poff, prow = tsnap.particle_layout(coords, L, offsets, parts)
    n = coords.shape[0]
    o = order.numpy()
    assert sorted(o.tolist()) == list(range(n))
    rank = np.empty(n, np.int64)
    rank[o] = np.arange(n)
    rows = np.repeat(np.arange(halos.numel()), np.diff(offsets.numpy()))
    key = rank[parts.numpy()]
    want = rows[np.argsort(key, kind="stable")]
    np.testing.assert_array_equal(prow.numpy(), want)
    np.testing.assert_array_equal(
        np.diff(poff.numpy()), np.bincount(key, minlength=n))
    assert poff[0] == 0 and poff[-1] == parts.numel()
    assert (np.diff(poff.numpy())[rank[n - 40:]] == 0).all()
    assert halos.numel() < 12             # halos without rows
    # the Morton key of each particle's cell, ascending along the order
    bits = 30 // ndim
    cell = np.clip((np.mod(coords.numpy(), L) * ((1 << bits) / L)).astype(
        np.int64), 0, (1 << bits) - 1)
    mk = np.zeros(n, np.int64)
    for b in range(bits):
        for c in range(ndim):
            mk |= ((cell[:, c] >> b) & 1) << (ndim * b + ndim - 1 - c)
    assert (np.diff(mk[o]) >= 0).all()
    assert tsnap.particle_order(coords, L).dtype == torch.int32


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_equals_halo_major_reference(ndim, dt, seed):
    """snapshot_gather_plain against snapshot_displace_plain on the same
    pairs (also in index order, no space order): float64 to 1e-14 of the
    largest offset, float32 to tests/test_snapshot.py:67; both bitwise
    here. The CPU wrapper runs the gather."""
    args = _pairs(ndim, TDT[dt], seed)
    coords, L = args[0], args[-1]
    offsets, parts = args[3], args[4]
    want = tsnap.snapshot_displace_plain(*args)
    ident = torch.arange(coords.shape[0], dtype=torch.int32)
    for layout in (tsnap.particle_layout(coords, L, offsets, parts),
                   (ident,) + tsnap.particle_major_plain(offsets, parts,
                                                         ident)):
        got = tsnap.snapshot_gather_plain(*args, layout)
        assert got.dtype == TDT[dt] and got.shape == want.shape
        assert torch.equal(got, want)
        if dt == "f64":
            torch.testing.assert_close(got, want, rtol=0, atol=1e-14 * float(
                want.abs().max()))
        else:
            torch.testing.assert_close(got, want, rtol=1e-3, atol=5e-4)
        assert torch.equal(tsnap.snapshot_displace(*args, layout), got)
    assert float(want.abs().max()) > 0


def test_snapshot_displace_refuses_a_bad_layout():
    args = _pairs(3, torch.float64, 0)
    order, poff, prow = tsnap.particle_layout(args[0], args[-1], args[3],
                                              args[4])
    with pytest.raises(ValueError, match="layout prow"):
        tsnap.snapshot_displace(*args, (order, poff, prow[:-1]))
    with pytest.raises(ValueError, match="layout order"):
        tsnap.snapshot_displace(*args, (order.long(), poff, prow))


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("ndim", [3, 2])
def test_gather_matches_jax_snapshot(models, ndim, dt):
    """The runner's own inputs (pairs, layout, curves) through the gather,
    added to the positions and wrapped as process() does, against the JAX
    BaryonifySnapshot on tests/test_torch_snapshot.py's boxes."""
    jm, tm = models[ndim]
    _, L, n, nh, logM, seed = BOXES[ndim]
    pos, hpos, M = _box(ndim, L, n, nh, logM, seed)
    assert ndim == 2 or _query_radii(tm, M, ndim, L)[1].max() <= L / 3
    jcat, jsnap = _objects(JUtils, ndim, L, pos, hpos, M)
    want = _moves(JSnapshot(jcat, jsnap, epsilon_max=20, model=jm,
                            verbose=False, dtype=JDT[dt]).process(), pos, L)
    runner = bf.BaryonifySnapshot(*_objects(bf.utils, ndim, L, pos, hpos, M),
                                  epsilon_max=20, model=tm, dtype=TDT[dt],
                                  device="cpu")
    args = runner._displace_inputs(_PhaseClock(torch.device("cpu")))
    order, poff, prow = args[-1]
    assert poff.numel() == n + 1 and prow.numel() == args[4].numel()
    off = tsnap.snapshot_gather_plain(*args).numpy().T
    new = pos + off
    new = np.where(new > L, new - L, new)
    new = np.where(new < 0, new + L, new)
    assert np.abs(want).max() > 0.05
    _close(_moves({c: new[:, i] for i, c in enumerate("xyz"[:ndim])},
                  pos, L), want, dt)


# -- K16: the tile windows ---------------------------------------------------
def _grid_case(ndim, N, reach, rdt, seed):
    """Offsets within +-reach cells (float32; a fifth exactly 0, some NaN
    and inf), the sources of every face pushed across it, and a map of
    values in (0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    nflat = N ** ndim
    po = rng.uniform(-reach, reach, (ndim, nflat))
    po[:, ::5] = 0.0
    lat = np.stack(np.unravel_index(np.arange(nflat), (N,) * ndim))
    for d in range(ndim):
        po[d, lat[d] == 0] = -rng.uniform(0, min(reach, 0.99),
                                          (lat[d] == 0).sum())
        po[d, lat[d] == N - 1] = rng.uniform(0, min(reach, 0.99),
                                             (lat[d] == N - 1).sum())
    po = po.astype(np.float32)
    po[0, ::97] = np.nan
    po[ndim - 1, ::89] = np.inf
    orig = rng.uniform(0.5, 1.5, nflat)
    return torch.as_tensor(po), torch.as_tensor(orig).to(rdt), lat


def _jax_deposit(po, orig, N, ndim, lat):
    jpo = jnp.asarray(po.numpy().T)
    jpo = jnp.where(jnp.isfinite(jpo), jpo, 0.0).astype(jnp.float64)
    fn = jscatter.deposit_2d if ndim == 2 else jscatter.deposit_3d
    return np.asarray(fn(jnp.zeros((N,) * ndim), jnp.asarray(lat.T) + jpo,
                         jnp.asarray(orig.numpy()))).reshape(-1)


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("reach", [0.999, 5.0])
@pytest.mark.parametrize("ndim,N", [(2, 33), (2, 70), (3, 24), (3, 33)])
def test_windows_equal_the_deposit(ndim, N, reach, rdt):
    """grid_deposit_windows_plain against grid_deposit_plain (and, in
    float64, the JAX deposit of the lattice plus the finite offsets):
    float64 to 1e-12 of the largest value and mass to 1e-12, float32 to
    1e-5; no corner spills when every offset is under one cell, some do
    at 5; tiles other than K16's too."""
    po, orig, lat = _grid_case(ndim, N, reach, rdt, N)
    want = tscatter.grid_deposit_plain(po, orig, N, ndim)
    rel = 1e-12 if rdt == torch.float64 else 1e-5
    tiles = [tscatter.TILE[ndim], (5,) * ndim]
    for tile in tiles:
        counts = {}
        got = tscatter.grid_deposit_windows_plain(po, orig, N, ndim, tile,
                                                  counts)
        assert got.dtype == rdt
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=rel * float(want.abs().max()))
        assert abs(float(got.double().sum()) / float(orig.double().sum())
                   - 1) < rel
        assert (counts["spilled"] > 0) == (reach > 1)
        assert counts["sources"] == N ** ndim
        assert counts["zero_offset"] == int(
            ((po == 0) | ~torch.isfinite(po)).all(0).sum())
        assert 0 < counts["flushed"] <= counts["corners"]
    if rdt == torch.float64:
        ref = _jax_deposit(po, orig, N, ndim, lat)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-12 * ref.max())


@pytest.mark.parametrize("ndim,N", [(2, 24), (3, 12)])
def test_windows_zero_skip_keeps_non_finite_values(ndim, N):
    """A value of inf moved by exactly 0 (its other corners have weight 0:
    inf times 0 is NaN, and those corners are kept) and a NaN value: the
    same non-finite cells as grid_deposit_plain and the JAX deposit, the
    finite cells to 1e-12 of the largest; a zero value adds nothing."""
    po, orig, lat = _grid_case(ndim, N, 0.9, torch.float64, 3)
    po[:, 10] = 0.0
    po[:, 50] = 0.25
    orig[10] = float("inf")
    orig[50] = float("nan")
    orig[60] = 0.0
    want = tscatter.grid_deposit_plain(po, orig, N, ndim)
    got = tscatter.grid_deposit_windows_plain(po, orig, N, ndim)
    ref = torch.as_tensor(np.array(_jax_deposit(po, orig, N, ndim, lat)))
    for other in (want, ref):
        assert torch.equal(torch.isnan(got), torch.isnan(other))
        assert torch.equal(torch.isinf(got), torch.isinf(other))
    fin = torch.isfinite(want)
    assert int((~fin).sum()) >= 2 ** ndim
    torch.testing.assert_close(got[fin], want[fin], rtol=0,
                               atol=1e-12 * float(want[fin].abs().max()))
