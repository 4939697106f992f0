"""The direct readout's kernels (K20-K23) against their plain versions, and
the runners' direct paths on the card against the CPU.

Marked ``cuda``: each test skips without a CUDA device. This file imports
no jax; run it on the card as

    python -m pytest --noconftest -m cuda tests/test_torch_direct_cuda.py

Tolerances: K20's layout, formed on the card, equal to row_layout's of
its counts, and its pad slots equal to the fills they replace; the rows'
integers (layout, pixels, halos) equal in float64,
and in float32 but for members on a disc's edge, which the device's sinf
may keep where torch drops them (counted, at most 1e-3 of the members); r
and the geometry per member to the gap between the device's and torch's
pixel angles (math libraries that round a transcendental a few ulps
apart) times D / a, 1 and D, beside 4 ulps of their scale; K21's and
K22's sums to 1e-10 of the largest value in
float64 and 1e-5 in float32 (the plain versions' atomic sums run in
another order); K22's and K23's radii bitwise (the same operations); K23's
gather bitwise (the same sums in the same order); one K22 apply over
consecutive runs of halos bitwise the applies of the runs in turn (each
tile adds its halos in ascending order, its running sums in the map's
type); the runners' direct maps on the card to 1e-9 of the largest value
of the CPU's, float64.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import deposit, direct, grid     # noqa: E402
from baryonforge_torch.ops import paint, snapshot           # noqa: E402
from baryonforge_torch.ops import healpix as hpx            # noqa: E402
from baryonforge_torch.Runners import Map2DRunner           # noqa: E402

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(__file__)
TABLE = os.path.join(HERE, os.pardir, "tools", "_northstar_table.npz")
TSZ_TABLE = os.path.join(HERE, "data", "tsz_bench_table.npz")
COSMO = dict(Omega_m=0.30, Omega_b=0.045, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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


def _cosmo():
    return bf.cosmo.cosmology_from_dict(COSMO)


def _s19():
    return bf.Baryonification2D(None, None, _cosmo(),
                                epsilon_max=20).load_table(TABLE)


def _tsz():
    """The bench's tSZ table; its proj_cutoff (100, as it was built with)
    sets the Anis background's depth."""
    tab = bf.utils.TabulatedProfile(
        None, _cosmo(), mass_def=bf.cosmo.MassDef200c).load_table(TSZ_TABLE)
    tab.proj_cutoff = 100
    return tab


def _shell_inputs(nside, n, seed=7):
    """Bench-like halos, two at the poles, some near the caps, a third at
    the table's lowest masses (discs under 4 pixels at NSIDE 64)."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    dec[2:10] = rng.uniform(77, 84, 8) * rng.choice([-1, 1], 8)
    dec[0], dec[1] = 89.5, -89.5
    M = 10 ** rng.uniform(13.0, 14.8, n)
    M[2::3] = 10 ** rng.uniform(12.71, 12.8, M[2::3].size)
    z = rng.uniform(0.75, 1.05, n)
    cat = bf.utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                        cosmo=COSMO)
    shell = bf.utils.LightconeShell(
        map=rng.exponential(1.0, 12 * nside * nside), cosmo=COSMO,
        redshift=0.9)
    return cat, shell


def _halos(nside, n, eps, dev):
    cat, shell = _shell_inputs(nside, n)
    r = bf.PaintProfilesShell(cat, shell, epsilon_max=eps, model=_tsz(),
                              device=dev)
    hd = r._host_halo_data(_cosmo())
    return {k: torch.as_tensor(hd[k], dtype=torch.float64, device=dev)
            for k in ("theta", "phi", "radius", "D", "a", "M")}


def _same_layout(got, want):
    """Two host RowLayouts equal: bases, slots, groups (ids, width, first
    slot)."""
    np.testing.assert_array_equal(got.base, want.base)
    assert got.n_slots == want.n_slots
    assert [(K, s0) for _, K, s0 in got.groups] \
        == [(K, s0) for _, K, s0 in want.groups]
    for (h, _, _), (h0, _, _) in zip(got.groups, want.groups):
        np.testing.assert_array_equal(h, h0)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("mode", deposit.DIRECT_MODES)
@pytest.mark.parametrize("nside,n,eps", [(64, 300, 20), (256, 400, 20),
                                         (1024, 64, 60)])
def test_disc_radii_kernel(dev, monkeypatch, dt, mode, nside, n, eps):
    """K20's rows against the plain version's on the same card tensors;
    its layout, formed on the card, against row_layout's of its counts
    bit for bit, also under a budget that cuts its classes into several
    groups (the rows then the same); every pad slot written (pixel -1,
    halo, r and geometry 0) into rows the caching allocator hands out
    dirty."""
    halos = _halos(nside, n, eps, dev)
    dirty = torch.full((1 << 24,), -7, dtype=torch.int32, device=dev)
    del dirty
    _build.reset_launches()
    rows, lay = deposit.disc_radii(nside, halos, mode, dt)
    torch.cuda.synchronize()
    assert _build.launches["disc_radii"] == 3
    host = lay.numpy()
    _same_layout(host, direct.row_layout(host.counts))
    monkeypatch.setattr(direct, "ROW_BUDGET", 16)
    cut, lcut = deposit.disc_radii(nside, halos, mode, dt)
    monkeypatch.undo()
    want = direct.row_layout(host.counts, 16)
    assert len(want.groups) > len(lay.groups)
    _same_layout(lcut.numpy(), want)
    for k in ("pix", "hid", "r"):
        assert torch.equal(rows[k], cut[k])
    live = rows["pix"] >= 0
    assert int(live.sum()) == int(host.counts.sum())
    assert (rows["hid"][~live] == 0).all() and (rows["r"][~live] == 0).all()
    if mode == "displace":
        assert (rows["geo"][~live] == 0).all()
        assert torch.equal(rows["geo"], cut["geo"])
    else:
        assert rows["geo"] is None
    ref, lref = deposit.disc_radii_plain(nside, halos, mode, dt)
    if dt == torch.float64:
        np.testing.assert_array_equal(host.counts, lref.counts)
        assert torch.equal(rows["pix"], ref["pix"])
        assert torch.equal(rows["hid"], ref["hid"])
        # each member's pixel angles, the device's (K20 takes theta from
        # its ring, pix2ang's bit for bit on the card, and for anis and the
        # fallback phi from pix2ang's formula) against torch's (the plain
        # version's), differ by a few ulps where the two math libraries
        # round apart: r moves by at most that gap times D / a, the
        # tangent factors by the gap, D chord_safe by the gap times D,
        # each beside 4 ulps of the values' own scale
        live = ref["pix"] >= 0
        pix, h = ref["pix"][live], ref["hid"][live].long()
        t_dev, p_dev = paint.pixel_angles(nside, dt, dev, per_ring=False)
        t_pl, p_pl = hpx.pix2ang(nside, pix, dt)
        gap = (t_dev[pix.long()] - t_pl).abs() \
            + (p_dev[pix.long()] - p_pl).abs()
        eps = torch.finfo(dt).eps
        D, D_a = halos["D"][h], (halos["D"] / halos["a"])[h]
        r, r0 = rows["r"][live], ref["r"][live]
        assert ((r - r0).abs() <= (gap + 4 * eps) * D_a
                + 4 * eps * r0.abs()).all()
        if mode == "displace":
            err = (rows["geo"][live] - ref["geo"][live]).abs()
            assert (err[:, :2] <= (gap + 4 * eps)[:, None]).all()
            assert (err[:, 2] <= (gap + 4 * eps) * D).all()
        return
    # float32: a member on a disc's edge may flip; the sets otherwise equal
    off = np.abs(host.counts - lref.counts).sum()
    assert off <= 1e-3 * lref.counts.sum() + 2, off
    same = host.counts == lref.counts
    assert same.mean() > 0.99


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("mode", deposit.DIRECT_MODES)
@pytest.mark.parametrize("pix", [False, True], ids=["value", "pixel_size"])
def test_disc_apply_kernel(dev, dt, mode, pix):
    """K21 on the plain version's rows with random values (some not
    finite) against its plain version."""
    nside = 256
    halos = _halos(nside, 400, 20, dev)
    rows, lay = deposit.disc_radii_plain(nside, halos, mode, dt)
    g = torch.Generator(device=dev).manual_seed(3)
    n = lay.n_slots
    vdt = dt if mode == "paint" else torch.float64
    vals = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    vals[::97] = float("nan")
    vals = vals.to(vdt)
    kw = {}
    if mode == "anis":
        npix = hpx.npix(nside)
        kw = dict(vals2=torch.rand(n, generator=g, device=dev,
                                   dtype=torch.float64),
                  mtot=torch.rand(npix, generator=g, device=dev,
                                  dtype=torch.float64) + 0.1,
                  orig=torch.rand(npix, generator=g, device=dev,
                                  dtype=torch.float64))
    _build.reset_launches()
    got = paint.disc_apply(mode, nside, rows, vals, halos, pixel_size=pix,
                           acc_dtype=dt, **kw)
    torch.cuda.synchronize()
    assert _build.launches["disc_apply"] == 1
    want = paint.disc_apply_plain(mode, nside, rows, vals, halos,
                                  pixel_size=pix, acc_dtype=dt, **kw)
    scale = want.abs().max().item()
    tol = 1e-10 if got.dtype == torch.float64 else 1e-5
    assert scale > 0
    assert (got - want).abs().max().item() <= tol * scale


def _grid_halos(ndim, npix, Ns, m, dev, ell=False, seed=2):
    rng = np.random.default_rng(seed)
    res = 100.0 / npix
    h = {"cen": torch.as_tensor(rng.integers(0, npix, (m, ndim)),
                                dtype=torch.int32, device=dev),
         "doff": torch.as_tensor(rng.uniform(-0.5, 0.5, (m, ndim)) * res,
                                 device=dev),
         "rmax": torch.as_tensor(rng.uniform(0.3, 0.6, m) * Ns * res,
                                 device=dev),
         "rmat": None}
    if ell:
        h["rmat"] = torch.as_tensor(rng.normal(size=(m, 2, 2)), device=dev)
    return h, res


@pytest.mark.parametrize("ndim,npix,Ns,ell", [(2, 64, 20, False),
                                              (2, 50, 13, True),
                                              (3, 26, 9, False)])
def test_grid_radii_kernel(dev, ndim, npix, Ns, ell):
    """K22's radii pass bitwise its plain version."""
    h, res = _grid_halos(ndim, npix, Ns, 40, dev, ell)
    got = grid.grid_radii(npix, Ns, res, h)
    want = grid.grid_radii_plain(npix, Ns, res, h)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("mode", grid.MODES)
@pytest.mark.parametrize("ndim,npix,Ns", [(2, 64, 20), (3, 26, 9)])
def test_grid_direct_kernel(dev, dt, mode, ndim, npix, Ns):
    """K22's apply against its plain version on random values (some not
    finite), into a non-zero accumulator."""
    if mode == "anis" and ndim == 3:
        pytest.skip("the anisotropic paint is 2D only")
    h, res = _grid_halos(ndim, npix, Ns, 40, dev)
    if mode == "displace":
        h["rmax"] = torch.full_like(h["rmax"], float("inf"))
    g = torch.Generator(device=dev).manual_seed(5)
    n = 40 * Ns ** ndim
    vdt = dt if mode == "displace" else torch.float64
    vals = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    vals[::101] = float("inf")
    vals = vals.to(vdt)
    nflat = npix ** ndim
    kw = {}
    if mode == "anis":
        kw = dict(vals2=torch.rand(n, generator=g, device=dev,
                                   dtype=torch.float64),
                  mtot=torch.rand(nflat, generator=g, device=dev,
                                  dtype=torch.float64),
                  orig=torch.rand(nflat, generator=g, device=dev,
                                  dtype=torch.float64))
    shape = (ndim, nflat) if mode == "displace" else (nflat,)
    acc0 = torch.rand(shape, generator=g, device=dev,
                      dtype=torch.float64).to(vdt)
    _build.reset_launches()
    got = grid.grid_direct(mode, npix, Ns, res, h, vals, acc0.clone(), **kw)
    torch.cuda.synchronize()
    assert _build.launches["grid_direct"] == 1
    want = grid.grid_direct_plain(mode, npix, Ns, res, h, vals, acc0.clone(),
                                  **kw)
    tol = 1e-10 if vdt == torch.float64 else 1e-5
    scale = (want - acc0).abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= tol * scale
    again = grid.grid_direct(mode, npix, Ns, res, h, vals, acc0.clone(), **kw)
    assert torch.equal(got, again)
    # the same halos in three runs, applied in turn: bit for bit one apply
    cells = Ns ** ndim
    acc = acc0.clone()
    for a, b in ((0, 7), (7, 23), (23, 40)):
        part = {k: None if v is None else v[a:b] for k, v in h.items()}
        extra = dict(kw, vals2=kw["vals2"][a * cells:b * cells]) \
            if mode == "anis" else kw
        grid.grid_direct(mode, npix, Ns, res, part,
                         vals[a * cells:b * cells], acc, **extra)
    assert torch.equal(acc, got)


@pytest.mark.parametrize("ndim,npix,Ns,m", [(2, 64, 20, 40), (3, 26, 9, 40),
                                            (3, 64, 6, 3), (2, 50, 13, 0)])
def test_touched_tiles_kernel_lists(dev, ndim, npix, Ns, m):
    """The compacted touched tiles of K22's apply are exactly the tiles
    with a nonempty list, read with nothing synchronized."""
    h, res = _grid_halos(ndim, npix, Ns, max(m, 1), dev)
    h = {k: None if v is None else v[:m] for k, v in h.items()}
    if m == 0:
        n_tiles = (-(-npix // grid.TILE[ndim])) ** ndim
        start = torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev)
    else:
        start, _ = grid.cutout_tiles(npix, Ns, res, h)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tiles, work = grid.touched_tiles(start)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = torch.nonzero(start[1:] > start[:-1])[:, 0].int()
    assert work.tolist() == [want.numel(), 0]
    assert torch.equal(tiles[:want.numel()], want)


def _pairs(ndim, L, n_part, n_halos, R, dev, seed=4):
    rng = np.random.default_rng(seed)
    coords = torch.as_tensor(rng.uniform(0, L, (n_part, ndim)), device=dev)
    hpos = torch.as_tensor(rng.uniform(0, L, (n_halos, ndim)), device=dev)
    dx = coords[None, :, :] - hpos[:, None, :]
    dx = torch.where(dx > L / 2, dx - L, dx)
    dx = torch.where(dx < -L / 2, dx + L, dx)
    near = (dx * dx).sum(-1) < R * R
    h, p = torch.nonzero(near, as_tuple=True)
    counts = torch.bincount(h, minlength=n_halos)
    keep = counts > 0
    halos = torch.nonzero(keep)[:, 0].int()
    offsets = torch.zeros(int(keep.sum()) + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts[keep], 0)
    parts = p.int()
    layout = snapshot.particle_layout(coords, L, offsets, parts)
    return coords, hpos, halos, offsets, parts, layout


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("ndim", [2, 3])
def test_snapshot_direct_kernels(dev, dt, ndim):
    """K23's radii pass and gather bitwise their plain versions, and
    neither wrapper synchronizes with the host."""
    L = 50.0
    coords, hpos, halos, offsets, parts, layout = _pairs(ndim, L, 3000, 60,
                                                         9.0, dev)
    dlay = snapshot.direct_layout(coords, halos, offsets, parts, layout[0])
    g = torch.Generator(device=dev).manual_seed(7)
    vals = torch.randn(dlay.rows.n_slots, generator=g, device=dev,
                       dtype=torch.float64).to(dt)
    vals[::53] = float("nan")
    _build.library()
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r = snapshot.snapshot_radii(hpos, halos, offsets, dlay, L)
        got = snapshot.snapshot_direct(hpos, layout[:2], dlay, vals, L)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _build.launches["snapshot_radii"] == 1
    assert _build.launches["snapshot_direct"] == 1
    r0 = snapshot.snapshot_radii_plain(hpos, halos, offsets, dlay, L)
    assert torch.equal(r, r0)
    want = snapshot.snapshot_direct_plain(hpos, layout[:2], dlay, vals, L)
    assert torch.equal(got, want)


def test_snapshot_radii_kernel_long_rows(dev):
    """K23's radii on rows longer than a piece (RADII_PIECE pairs), with
    rows of 1 to 3 pairs beside them: bitwise the plain version, pads 0."""
    L = 40.0
    coords, hpos, halos, offsets, parts, layout = _pairs(
        3, L, 20000, 40, 14.0, dev, seed=9)
    counts = (offsets[1:] - offsets[:-1]).cpu().numpy()
    assert counts.max() > 2 * snapshot.RADII_PIECE
    dlay = snapshot.direct_layout(coords, halos, offsets, parts, layout[0])
    r = snapshot.snapshot_radii(hpos, halos, offsets, dlay, L)
    assert torch.equal(r, snapshot.snapshot_radii_plain(hpos, halos, offsets,
                                                        dlay, L))


def _close(got, want, scale=None):
    scale = np.abs(want).max() if scale is None else scale
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * scale)


def test_direct_shells_cuda_match_cpu(dev):
    """BaryonifyShell, PaintProfilesShell and PaintProfilesAnisShell with
    models that expose only their readout, on the card (K20, K21, K3, K14)
    against the CPU, float64."""
    cat, shell = _shell_inputs(64, 300)
    s19, tsz = _s19(), _tsz()
    kw = dict(epsilon_max=20, dtype=torch.float64,
              regrid_dtype=torch.float64)
    _build.reset_launches()
    out = bf.BaryonifyShell(cat, shell, model=_Hide(s19.with_dtype(
        torch.float64, device=dev)), device=dev, **kw).process()
    assert _build.launches["disc_radii"] == 3
    assert _build.launches["disc_apply"] == 1
    assert _build.launches["regrid"] == 1
    ref = bf.BaryonifyShell(cat, shell, model=_Hide(s19), device="cpu",
                            **kw).process()
    _close(out, ref, np.abs(ref - shell.map).max())
    models = {dev: _Hide(tsz.with_dtype(torch.float64, device=dev)),
              "cpu": _Hide(tsz)}

    def run(cls, d):
        extra = {} if cls is bf.PaintProfilesShell else dict(
            Tracer_model=models[d], Mtot_model=tsz, background_val=1.0,
            global_tracer_fraction=0.1)
        return cls(cat, shell, model=models[d], device=d, **extra,
                   **kw).process()
    for cls in (bf.PaintProfilesShell, bf.PaintProfilesAnisShell):
        _build.reset_launches()
        out = run(cls, dev)
        assert _build.launches["disc_apply"] == 1
        _close(out, run(cls, "cpu"))


@pytest.mark.parametrize("which,ndim,ell", [("baryonify", 3, False),
                                              ("paint", 3, False),
                                              ("anis", 2, False),
                                              ("baryonify", 2, True)])
def test_direct_grid_chunk_groups_cuda(dev, monkeypatch, which, ndim, ell):
    """The grid runners' direct readout with a readout chunk a halo: one
    apply a size bucket (a group from the bucket's first chunk across all
    of them) equals an apply a chunk bit for bit (BaryonifyGrid's offsets,
    the paints' maps), with fewer applies than chunks, and the map
    matches the CPU to 1e-9 of its largest value (float64)."""
    rng = np.random.default_rng(11)
    N, L, n = (40, 80.0, 25) if ndim == 2 else (24, 60.0, 14)
    bins = (np.arange(N) + 0.5) * (L / N)
    cols = dict(x=rng.uniform(0, L, n), y=rng.uniform(0, L, n))
    if ndim == 3:
        cols["z"] = rng.uniform(0, L, n)
    if ell:
        cols.update(q_ell=rng.uniform(0.5, 1.0, n),
                    A_ell=rng.normal(size=(n, 2)))
    cat = bf.utils.HaloNDCatalog(M=10 ** rng.uniform(13.5, 14.8, n),
                                 redshift=0.9, cosmo=COSMO, **cols)
    gm = bf.utils.GriddedMap(map=rng.exponential(1.0, (N,) * ndim),
                             bins=bins, cosmo=COSMO, redshift=0.9)
    s19 = (bf.Baryonification2D if ndim == 2 else bf.Baryonification3D)(
        None, None, _cosmo(), epsilon_max=20).load_table(TABLE)
    tsz = _tsz()
    monkeypatch.setattr(Map2DRunner, "GRID_CELL_BUDGET", 1)

    def run(d, value_budget):
        monkeypatch.setattr(Map2DRunner, "GRID_VALUE_BUDGET", value_budget)
        m = s19 if which == "baryonify" else tsz
        rd = m.with_dtype(torch.float64, device=d) if d != "cpu" else m
        kw = dict(epsilon_max=5, model=_Hide(rd), dtype=torch.float64,
                  device=d, n_size_buckets=2, use_ellipticity=ell)
        if which == "anis":
            kw.update(Tracer_model=_Hide(rd), Mtot_model=tsz,
                      background_val=1.0, global_tracer_fraction=0.1)
        cls = {"baryonify": bf.BaryonifyGrid, "paint": bf.PaintProfilesGrid,
               "anis": bf.PaintProfilesAnisGrid}[which]
        r = cls(cat, gm, **kw)
        _build.reset_launches()
        if which == "baryonify":
            # K22's offsets: K16's deposit after them sums with atomics,
            # in an order that varies from run to run
            sums = r._all_cutouts(r._cutout_inputs(Map2DRunner._PhaseClock(
                r.device))).cpu().numpy()
            launches = dict(_build.launches)
            return r.process(), sums, launches
        out = r.process()
        return out, out, dict(_build.launches)

    _, one, l1 = run(dev, 1)
    out, grouped, lg = run(dev, 1 << 40)
    np.testing.assert_array_equal(grouped, one)
    assert l1["grid_direct"] == n                 # an apply a chunk
    assert lg["grid_direct"] == 2                 # an apply a bucket
    assert lg["grid_radii"] == lg["grid_direct"]
    ref, _, _ = run("cpu", 1 << 40)
    base = gm.map if which == "baryonify" else 0
    _close(out, ref, np.abs(ref - base).max())


def test_direct_grids_and_snapshot_cuda_match_cpu(dev):
    """The grid runners (K22) and BaryonifySnapshot (K23) with models that
    expose only their readout, on the card against the CPU, float64."""
    rng = np.random.default_rng(8)
    N, L, n = 40, 80.0, 25
    bins = (np.arange(N) + 0.5) * (L / N)
    cat = bf.utils.HaloNDCatalog(x=rng.uniform(0, L, n),
                                 y=rng.uniform(0, L, n),
                                 M=10 ** rng.uniform(13.5, 14.8, n),
                                 redshift=0.9, cosmo=COSMO)
    gm = bf.utils.GriddedMap(map=rng.exponential(1.0, (N, N)), bins=bins,
                             cosmo=COSMO, redshift=0.9)
    s19, tsz = _s19(), _tsz()
    for cls, m in ((bf.BaryonifyGrid, s19), (bf.PaintProfilesGrid, tsz)):
        kw = dict(epsilon_max=5, model=_Hide(m), dtype=torch.float64)
        _build.reset_launches()
        out = cls(cat, gm, device=dev, **dict(kw, model=_Hide(m.with_dtype(
            torch.float64, device=dev)))).process()
        assert _build.launches["grid_radii"] >= 1
        assert _build.launches["grid_direct"] >= 1
        ref = cls(cat, gm, device="cpu", **kw).process()
        _close(out, ref, np.abs(ref - (gm.map if cls is bf.BaryonifyGrid
                                       else 0)).max())
    pos = rng.uniform(0, L, (4000, 3))
    snap = bf.utils.ParticleSnapshot(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2],
                                     M=np.ones(len(pos)), L=L, redshift=0.9,
                                     cosmo=COSMO)
    hcat = bf.utils.HaloNDCatalog(x=rng.uniform(0, L, n),
                                  y=rng.uniform(0, L, n),
                                  z=rng.uniform(0, L, n),
                                  M=10 ** rng.uniform(13.5, 14.5, n),
                                  redshift=0.9, cosmo=COSMO)
    s3 = bf.Baryonification3D(None, None, _cosmo(),
                              epsilon_max=20).load_table(TABLE)
    kw = dict(epsilon_max=20, model=_Hide(s3), dtype=torch.float64,
              verbose=False)
    _build.reset_launches()
    out = bf.BaryonifySnapshot(hcat, snap, device=dev, **dict(
        kw, model=_Hide(s3.with_dtype(torch.float64, device=dev)))).process()
    assert _build.launches["snapshot_radii"] == 1
    assert _build.launches["snapshot_direct"] == 1
    ref = bf.BaryonifySnapshot(hcat, snap, device="cpu", **kw).process()
    for c in "xyz":
        np.testing.assert_allclose(out[c], ref[c], rtol=0, atol=1e-9)
