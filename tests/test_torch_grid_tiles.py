"""K15's (tile, halo) lists (ops.grid.cutout_tiles), on the CPU.

The kernel adds a halo's cutout only into the tiles listed for it, so the
lists must hold every (cell, halo) that adds: each cell with r < rmax inside
the halo's wrapped box of Ns^d cells (r from the plain version's own
geometry, ops.grid._geometry) must lie in a tile listed with that halo, and
each tile's halos must be in ascending index (the kernel's fixed order of
sums). Grids of N <= 32 with partial last tiles, halos across the periodic
edges, overlapping boxes, odd Ns (the runners' N // 2 clip is odd when
N = 2 mod 4), a box whose last cell starts a tile, Ns = N, with and without
ellipticity.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

from baryonforge_torch.ops import grid as tgrid              # noqa: E402
from baryonforge_torch.Runners.Map2DRunner import _shear_matrix  # noqa: E402


def _halos(ndim, npix, n, ell, seed):
    rng = np.random.default_rng(seed)
    cen = rng.integers(0, npix, (n, ndim)).astype(np.int32)
    cen[0] = 0
    cen[1] = npix - 1
    halos = {"cen": torch.as_tensor(cen),
             "doff": torch.as_tensor(rng.uniform(-0.5, 0.5, (n, ndim))),
             "rmax": torch.as_tensor(rng.uniform(1.0, 0.7 * npix, n)),
             "rscale": None, "rmat": None}
    if ell:
        halos["rmat"] = torch.as_tensor(_shear_matrix(
            rng.normal(size=(n, 2)), rng.uniform(0.5, 0.9, n)))
    return halos


def _tile_of(flat, npix, ndim):
    T = tgrid.TILE[ndim]
    nt = -(-npix // T)
    tile = torch.zeros_like(flat)
    rest = flat
    for d in reversed(range(ndim)):
        tile = tile + (rest % npix) // T * nt ** (ndim - 1 - d)
        rest = rest // npix
    return tile


@pytest.mark.parametrize("ndim,npix,ell", [(2, 20, False), (2, 32, True),
                                           (2, 24, False), (2, 26, True),
                                           (3, 12, False), (3, 20, False),
                                           (3, 26, False)])
@pytest.mark.parametrize("Ns", [4, 5, 10, "N/2", "N"])
def test_cutout_tiles_hold_every_live_cell(ndim, npix, ell, Ns):
    Ns = {"N": npix, "N/2": npix // 2}.get(Ns, Ns)
    res = 1.0
    T = tgrid.TILE[ndim]
    halos = _halos(ndim, npix, 24, ell, seed=npix + Ns + ndim)
    # halo 2's box ends on the first cell of a tile on every axis
    halos["cen"][2] = (T - (Ns - 1 - Ns // 2)) % npix
    halos["rmax"][2] = float(npix)
    start, owner = tgrid.cutout_tiles(npix, Ns, res, halos)
    n_tiles = (-(-npix // T)) ** ndim
    assert start.dtype == torch.int32 and owner.dtype == torch.int32
    assert start.shape == (n_tiles + 1,) and int(start[0]) == 0
    assert int(start[-1]) <= owner.numel()
    listed = set()
    for t in range(n_tiles):
        hs = owner[start[t]:start[t + 1]].tolist()
        assert hs == sorted(set(hs)), f"tile {t}: {hs}"
        listed.update((t, h) for h in hs)
    flat, _, r = tgrid._geometry(npix, Ns, res, halos["cen"], halos["doff"],
                                 halos["rmat"])
    live = r < halos["rmax"][:, None]
    assert live.any()
    hh = torch.arange(flat.shape[0])[:, None].expand_as(flat)
    tiles = _tile_of(flat, npix, ndim)
    need = set(zip(tiles[live].tolist(), hh[live].tolist()))
    assert need <= listed, sorted(need - listed)[:10]
    # every listed pair's tile meets the halo's box
    boxed = set(zip(tiles.reshape(-1).tolist(), hh.reshape(-1).tolist()))
    assert listed <= boxed


def test_cutout_tiles_empty_chunked_and_pruned(monkeypatch):
    """No halos give empty lists; halo chunks give the lists of one pass;
    small rmax drops tiles that the boxes meet, ellipticity drops none."""
    halos = _halos(3, 20, 30, False, seed=5)
    small = dict(halos, rmax=torch.full((30,), 2.0, dtype=torch.float64))
    n_pairs = [int(tgrid.cutout_tiles(20, 16, 1.0, h)[0][-1])
               for h in (halos, small)]
    assert n_pairs[1] < n_pairs[0]
    flat = tgrid.cutout_tiles(2 * 16, 16, 1.0, _halos(2, 32, 30, True, 6))
    boxed = tgrid.cutout_tiles(2 * 16, 16, 1.0, dict(
        _halos(2, 32, 30, True, 6), rmax=torch.full((30,), 1e-3,
                                                     dtype=torch.float64)))
    assert torch.equal(flat[0], boxed[0])
    empty = {k: None if v is None else v[:0] for k, v in halos.items()}
    start, owner = tgrid.cutout_tiles(20, 10, 1.0, empty)
    assert int(start.abs().max()) == 0
    whole = tgrid.cutout_tiles(20, 10, 1.0, halos)
    monkeypatch.setattr(tgrid, "_CHUNK_PAIRS", 1)
    chunked = tgrid.cutout_tiles(20, 10, 1.0, halos)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1][:int(whole[0][-1])], chunked[1])
