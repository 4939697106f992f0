"""The layouts that kernels K22 and K23 read, on the CPU (torch only): K23's
per-pair-set layout (each row's slots and pieces, each particle-major
entry's (slot, halo) record) and its radii and gather walks emulated step
by step against their plain versions; K22's touched-tile list and its
applies over runs of chunks.

Tolerances: none. The records equal the index arithmetic they replace;
the emulated walks form each value and add each term as the kernels do
(a square root by torch's, as the plain versions take it: torch's CPU
float64 square root is not always correctly rounded), so they equal the
plain versions bit for bit; one K22 apply over consecutive
runs of halos equals the applies of the runs in turn bit for bit (each
cell's values are added in ascending halo order, the running sum held in
the map's type), in the plain version and in the grid runners.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import direct, grid, snapshot    # noqa: E402
from baryonforge_torch.Runners import Map2DRunner           # noqa: E402

COSMO = dict(Omega_m=0.30, Omega_b=0.045, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)


def _pairs(ndim, L, n_part, n_halos, R, seed=4):
    """Brute-force pairs within R of random halos, as the runner's CSR
    (halos without particles have no row) and K17's layout."""
    rng = np.random.default_rng(seed)
    coords = torch.as_tensor(rng.uniform(0, L, (n_part, ndim)))
    hpos = torch.as_tensor(rng.uniform(0, L, (n_halos, ndim)))
    dx = coords[None, :, :] - hpos[:, None, :]
    dx = torch.where(dx > L / 2, dx - L, dx)
    dx = torch.where(dx < -L / 2, dx + L, dx)
    h, p = torch.nonzero((dx * dx).sum(-1) < R * R, as_tuple=True)
    counts = torch.bincount(h, minlength=n_halos)
    keep = counts > 0
    halos = torch.nonzero(keep)[:, 0].int()
    offsets = torch.zeros(int(keep.sum()) + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(counts[keep], 0)
    parts = p.int()
    layout = snapshot.particle_layout(coords, L, offsets, parts)
    return coords, hpos, halos, offsets, parts, layout


# 3D and 2D boxes; the last has rows longer than two pieces
BOXES = [(3, 50.0, 3000, 60, 9.0), (2, 50.0, 2000, 40, 6.0),
         (3, 40.0, 9000, 12, 14.0)]


@pytest.fixture(scope="module", params=BOXES,
                ids=[f"{b[0]}d-{b[2]}" for b in BOXES])
def box(request):
    ndim, L, n_part, n_halos, R = request.param
    pairs = _pairs(ndim, L, n_part, n_halos, R)
    dlay = snapshot.direct_layout(pairs[0], *pairs[2:5], pairs[5][0])
    return L, pairs, dlay


def test_direct_layout_records(box):
    """Each particle-major entry's record is (its pair's slot in the rows,
    its row's halo): the slot base[row] + the pair's place in its row,
    taken in particle_major_pairs' order, and halos[prow]; each row's
    slots are its RowLayout base and width; the positions in K17's order
    at each pair's place there are the pair's particle's."""
    L, (coords, hpos, halos, offsets, parts, layout), dlay = box
    counts = (offsets[1:] - offsets[:-1]).numpy()
    rows = direct.row_layout(counts)
    assert np.array_equal(dlay.slots[:, 0].numpy(), rows.base)
    assert np.array_equal(dlay.slots[:, 1].numpy(),
                          direct.row_width(counts))
    assert dlay.rows.n_slots == rows.n_slots
    row = torch.repeat_interleave(torch.arange(counts.size),
                                  torch.as_tensor(counts))
    pslot = torch.as_tensor(rows.base)[row] \
        + torch.arange(row.numel()) - offsets.long()[row]
    pm = snapshot.particle_major_pairs(parts, layout[0])
    assert dlay.rec.dtype == torch.int32
    assert torch.equal(dlay.rec[:, 0].long(), pslot[pm])
    assert torch.equal(dlay.rec[:, 1], halos[layout[2].long()])
    assert torch.equal(dlay.coords, coords[layout[0].long()])
    assert dlay.parts.dtype == torch.int32
    assert torch.equal(dlay.coords[dlay.parts.long()], coords[parts.long()])


def test_radii_pieces_emulated(box):
    """K23's radii walk emulated piece by piece (a piece's pairs from j0,
    at most RADII_PIECE of them, their positions from the layout's
    Morton-ordered copy; the first piece writes the row's pads 0) on the
    layout's pieces: every slot written once, and r bitwise
    snapshot_radii_plain's."""
    L, (_, hpos, halos, offsets, _, _), dlay = box
    c, hp = dlay.coords.numpy(), hpos.numpy()
    off, pa, hs = offsets.numpy(), dlay.parts.numpy(), halos.numpy()
    r = np.full(dlay.rows.n_slots, np.nan)
    written = np.zeros(dlay.rows.n_slots, dtype=np.int64)
    half = L / 2
    for row, j0 in dlay.pieces.numpy():
        o0, count = off[row], off[row + 1] - off[row]
        base, width = dlay.slots[row].numpy()
        h = hp[hs[row]]
        j = np.arange(j0, min(count, j0 + snapshot.RADII_PIECE))
        d2 = np.zeros(j.size)
        for k in range(c.shape[1]):
            v = c[pa[o0 + j], k] - h[k]
            v = np.where(v > half, v - L, v)
            v = np.where(v < -half, v + L, v)
            d2 = d2 + v * v
        r[base + j] = torch.sqrt(torch.as_tensor(d2)).numpy()
        written[base + j] += 1
        if j0 == 0:
            r[base + count:base + width] = 0.0
            written[base + count:base + width] += 1
    assert (written == 1).all()
    want = snapshot.snapshot_radii_plain(hpos, halos, offsets, dlay,
                                         L).numpy()
    assert np.array_equal(r, want)
    assert np.array_equal(snapshot.snapshot_radii(
        hpos, halos, offsets, dlay, L).numpy(), want)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_gather_warps_emulated(box, dt):
    """K23's gather emulated warp by warp (32 particles, their entries 32
    at a time: each entry's particle by the binary search of the warp's
    offsets, its position from the layout's Morton-ordered copy, its term
    formed, then each particle's terms added in order) bitwise
    snapshot_direct_plain, non-finite values included."""
    L, (coords, hpos, halos, offsets, parts, layout), dlay = box
    rng = np.random.default_rng(3)
    vals = torch.as_tensor(rng.normal(size=dlay.rows.n_slots)).to(dt)
    vals[::37] = float("nan")
    want = snapshot.snapshot_direct_plain(hpos, layout[:2], dlay, vals, L)
    n_part, ndim = coords.shape
    order, poff = layout[0].long(), layout[1].long()
    rec = dlay.rec.long()
    acc = torch.zeros((ndim, n_part), dtype=dt)
    for s0 in range(0, n_part, 32):
        off = poff[torch.clamp(torch.arange(s0, s0 + 33), max=n_part)]
        e0, e1 = int(off[0]), int(off[32])
        total = torch.zeros((32, ndim), dtype=dt)
        for c0 in range(e0, e1, 32):
            k = torch.arange(c0, min(e1, c0 + 32))
            i = torch.zeros(k.numel(), dtype=torch.long)
            for step in (16, 8, 4, 2, 1):
                i = torch.where(off[i + step] <= k, i + step, i)
            dx = dlay.coords[s0 + i] - hpos[rec[k, 1]]
            dx = torch.where(dx > L / 2, dx - L, dx)
            dx = torch.where(dx < -L / 2, dx + L, dx)
            d2 = torch.zeros(k.numel(), dtype=torch.float64)
            for cc in range(ndim):
                d2 = d2 + dx[:, cc] * dx[:, cc]
            d = torch.sqrt(d2)
            d_safe = torch.where(d > 0, d, torch.ones_like(d))
            v = vals[rec[k, 0]]
            v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
            term = v[:, None] * (dx / d_safe[:, None]).to(dt)
            for kk in range(k.numel()):
                total[int(i[kk])] = total[int(i[kk])] + term[kk]
        n = min(32, n_part - s0)
        acc[:, order[s0:s0 + n]] = total[:n].T
    assert torch.equal(acc, want)
    assert torch.equal(snapshot.snapshot_direct(hpos, layout[:2], dlay, vals,
                                                L), want)


def _grid_halos(ndim, npix, Ns, m, ell=False, seed=2):
    rng = np.random.default_rng(seed)
    res = 100.0 / npix
    h = {"cen": torch.as_tensor(rng.integers(0, npix, (m, ndim)),
                                dtype=torch.int32),
         "doff": torch.as_tensor(rng.uniform(-0.5, 0.5, (m, ndim)) * res),
         "rmax": torch.as_tensor(rng.uniform(0.3, 0.6, m) * Ns * res),
         "rmat": None}
    if ell:
        h["rmat"] = torch.as_tensor(rng.normal(size=(m, 2, 2)))
    return h, res


@pytest.mark.parametrize("ndim,npix,Ns,m", [(2, 64, 20, 40), (3, 26, 9, 40),
                                            (3, 64, 6, 3), (2, 48, 13, 1)])
def test_touched_tiles(ndim, npix, Ns, m):
    """The compacted list of touched tiles names exactly the tiles whose
    cutout list is not empty, in ascending order, its length (and the
    apply's tile counter, 0) on the lists' device."""
    h, res = _grid_halos(ndim, npix, Ns, m)
    start, _ = grid.cutout_tiles(npix, Ns, res, h)
    tiles, work = grid.touched_tiles(start)
    want = torch.nonzero(start[1:] > start[:-1])[:, 0].int()
    assert work.dtype == torch.int32 and work.shape == (2,)
    assert int(work[0]) == want.numel() > 0 and int(work[1]) == 0
    assert torch.equal(tiles[:want.numel()], want)
    tiles, work = grid.touched_tiles(torch.zeros_like(start))
    assert work.tolist() == [0, 0]


CASES = [("displace", 3, torch.float32, False),
         ("displace", 2, torch.float32, True),
         ("paint", 3, torch.float64, False),
         ("anis", 2, torch.float64, False)]


@pytest.mark.parametrize("mode,ndim,dt,ell", CASES,
                         ids=[f"{c[0]}-{c[1]}d" for c in CASES])
def test_grid_apply_over_chunks(mode, ndim, dt, ell):
    """K22's plain apply over halos 0..m equals its applies over three
    consecutive runs of them in turn, bit for bit, into a non-zero map."""
    npix, Ns, m = (48, 13, 30) if ndim == 2 else (20, 7, 30)
    h, res = _grid_halos(ndim, npix, Ns, m, ell)
    if mode == "displace":
        h["rmax"] = torch.full_like(h["rmax"], float("inf"))
    rng = np.random.default_rng(6)
    cells = Ns ** ndim
    vals = torch.as_tensor(rng.normal(size=m * cells)).to(dt)
    vals[::61] = float("inf")
    nflat = npix ** ndim
    kw = {}
    if mode == "anis":
        kw = dict(vals2=torch.as_tensor(rng.uniform(size=m * cells)),
                  mtot=torch.as_tensor(rng.uniform(size=nflat)),
                  orig=torch.as_tensor(rng.uniform(size=nflat)))
    shape = (ndim, nflat) if mode == "displace" else (nflat,)
    acc0 = torch.as_tensor(rng.uniform(size=shape)).to(dt)
    once = grid.grid_direct(mode, npix, Ns, res, h, vals, acc0.clone(), **kw)
    acc = acc0.clone()
    for a, b in ((0, 4), (4, 19), (19, m)):
        part = {k: None if v is None else v[a:b] for k, v in h.items()}
        extra = dict(kw, vals2=kw["vals2"][a * cells:b * cells]) \
            if mode == "anis" else kw
        grid.grid_direct(mode, npix, Ns, res, part,
                         vals[a * cells:b * cells], acc, **extra)
    assert not torch.equal(once, acc0)
    assert torch.equal(acc, once)


class _Hide:
    """Only the readout surface of a model: the runners read it directly."""

    def __init__(self, m):
        self._m = m

    def displacement(self, *a, **k):
        return self._m.displacement(*a, **k)

    def projected(self, *a, **k):
        return self._m.projected(*a, **k)

    def real(self, *a, **k):
        return self._m.real(*a, **k)


class _Paint:
    """A profile read only directly: rho(r) = M / (1 + (r / 0.3)^2); its
    projection depth sets the Anis grid's background."""

    def __init__(self):
        self.proj_cutoff = 100

    def real(self, cosmo, r, M, a, **kw):
        return M * 1e-14 / (1 + (r / 0.3) ** 2)

    def projected(self, cosmo, r, M, a, **kw):
        return M * 1e-14 / (1 + (r / 0.5) ** 2)


class _Move:
    """A displacement read only directly: d(r) = 0.01 r exp(-r)."""

    def displacement(self, r, M, a, **kw):
        return 0.01 * r * torch.exp(-r) * (M / 1e14)


@pytest.mark.parametrize("which,ndim,ell", [("baryonify", 3, False),
                                            ("paint", 3, False),
                                            ("anis", 2, False),
                                            ("baryonify", 2, True)])
def test_grid_runner_groups_chunks(monkeypatch, which, ndim, ell):
    """The grid runners' direct readout with a readout chunk a halo: one
    apply a size bucket (the group from the bucket's first chunk across
    all of them) equals an apply a chunk, bit for bit, float32 offsets or
    float64 maps; radii and applies a group, readouts a chunk."""
    rng = np.random.default_rng(12)
    N, L, n = (32, 64.0, 12) if ndim == 2 else (16, 32.0, 9)
    cols = dict(x=rng.uniform(0, L, n), y=rng.uniform(0, L, n))
    if ndim == 3:
        cols["z"] = rng.uniform(0, L, n)
    if ell:
        cols.update(q_ell=rng.uniform(0.5, 0.9, n),
                    A_ell=rng.normal(size=(n, 2)))
    cat = bf.utils.HaloNDCatalog(M=10 ** rng.uniform(13.5, 14.8, n),
                                 redshift=0.2, cosmo=COSMO, **cols)
    gm = bf.utils.GriddedMap(map=rng.exponential(1.0, (N,) * ndim),
                             bins=(np.arange(N) + 0.5) * (L / N),
                             cosmo=COSMO, redshift=0.2)
    monkeypatch.setattr(Map2DRunner, "GRID_CELL_BUDGET", 1)
    calls = {"radii": 0, "apply": 0}
    radii, apply = Map2DRunner.grid_radii, Map2DRunner.grid_direct

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(Map2DRunner, "grid_radii", count("radii", radii))
    monkeypatch.setattr(Map2DRunner, "grid_direct", count("apply", apply))

    def run(value_budget):
        monkeypatch.setattr(Map2DRunner, "GRID_VALUE_BUDGET", value_budget)
        calls.update(radii=0, apply=0)
        kw = dict(epsilon_max=5, device="cpu", n_size_buckets=2,
                  use_ellipticity=ell)
        if which == "baryonify":
            r = bf.BaryonifyGrid(cat, gm, model=_Move(), dtype=torch.float32,
                                 **kw)
        elif which == "paint":
            r = bf.PaintProfilesGrid(cat, gm, model=_Paint(), **kw)
        else:
            r = bf.PaintProfilesAnisGrid(
                cat, gm, model=_Paint(), Tracer_model=_Paint(),
                Mtot_model=_Paint(), background_val=1.0,
                global_tracer_fraction=0.1, **kw)
        out = r.process()
        return out, dict(calls)

    one, c1 = run(1)
    grouped, cg = run(1 << 40)
    paints = 2 if which == "anis" else 1     # the Anis grid's Mtot paint too
    assert c1 == {"radii": paints * n, "apply": paints * n}
    assert cg == {"radii": paints * 2, "apply": paints * 2}
    base = gm.map if which == "baryonify" else 0
    assert np.abs(grouped - base).max() > 0
    np.testing.assert_array_equal(grouped, one)
