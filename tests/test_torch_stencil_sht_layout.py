"""The layouts of kernels K5 (stencil regrid) and K19 (Legendre transform),
checked on the CPU against the port's plain versions.

K5 reads each slab row's ring data from a per-NSIDE table
(``ops.stencil.ring_table``, in ``stencil_tables``) instead of evaluating
the ring functions, and forms each tile's weight tables once: r0 and rat
for every (target row, tap row), wth and y = r0 + c_src rat for every
(target row, tap row, slab column). The table must give exactly what
``_row_geometry`` gives, and the tables' sum in the kernel's order
(``stencil_weights_plain``, which also skips the tap rows whose wth are
all 0, as the kernel does) must be bitwise ``stencil_regrid_plain``'s.

K19 runs one recurrence for each pair of rings whose heights are exact
mirrors (``ops.sht.mirror_pairs``), relying on lambda_lm(-z) =
(-1)^(l-m) lambda_lm(z) bitwise; ``ops.sht.ring_heights`` mirrors the
south belt's heights, which the JAX formula misses by up to 2.2e-16.
Tolerances: K19's own, 4 n_ring eps of sum_r |F| |lambda| (the sums over
rings in another order); the mirrored against the JAX heights within a
tenth of it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

from baryonforge_tpu.utils import sht as jsht               # noqa: E402
from baryonforge_torch.ops import healpix as thp           # noqa: E402
from baryonforge_torch.ops import sht                       # noqa: E402
from baryonforge_torch.ops import stencil as ts             # noqa: E402
from baryonforge_torch.ops import tiles as tt               # noqa: E402

DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]
EPS = float(np.finfo(np.float64).eps)


# ---- K5 ------------------------------------------------------------------
@pytest.mark.parametrize("nside", [64, 256, 1024])
def test_ring_table_matches_row_geometry(nside):
    """Every slab row of every tile: the table's theta (rounded to the
    regrid dtype), dphi, and phi0 formed as the kernel forms it, bitwise
    _row_geometry's; colscale bitwise the plain version's."""
    tiling = tt.SkyTiling(nside)
    tables = ts.stencil_tables(tiling, tt.stencil_host_info(tiling), "cpu")
    ring = tables["ring"]
    assert ring["theta"].numel() == 4 * nside - 1
    arr = tiling.device_arrays("cpu")
    W = tables["W"]
    i0, s, S = arr["tile_i0"], arr["tile_s"], arr["tile_S"]
    r = i0[:, None] + torch.arange(-W, tiling.RB + W, dtype=torch.int32)
    rc = torch.clamp(r, 1, 4 * nside - 1).long() - 1
    nr, sh = ring["nr"][rc], ring["sh"][rc]
    j0c = tt._j0(s[:, None], nr, sh, S[:, None])
    phi0 = (j0c.double() + 0.5 * sh.double()) * ring["dphi"][rc]
    segC = tt._j0(s[:, None] + 1, nr, sh, S[:, None]) - j0c
    segL = (j0c - tt._j0((s[:, None] - 1) % S[:, None], nr, sh,
                         S[:, None])) % nr
    for rdt in DTYPES:
        r_ok, theta, dphi, phi0_g, segC_g, segL_g = ts._row_geometry(
            tiling, i0, s, S, W, rdt)
        assert torch.equal(ring["theta"][rc].to(rdt), theta)
        assert torch.equal(ring["dphi"][rc], dphi)
        assert torch.equal(phi0, phi0_g)
        assert torch.equal(segC, segC_g) and torch.equal(segL, segL_g)
        sin_r = torch.sin(theta)
        want = torch.where(sin_r > 1e-12, sin_r,
                           torch.ones_like(sin_r)) * dphi.to(rdt)
        assert torch.equal(ring["colscale"][rdt][rc], want)
    assert torch.equal(r_ok, (r >= 1) & (r <= 4 * nside - 1))


def _offsets(nside, polar, seed=5):
    """(npix, 2) offsets and the (npix,) map, numpy: moves of a tenth of a
    pixel around a few centres and of three pixels around two (hot
    tiles); with ``polar`` the two hot centres are the poles."""
    rng = np.random.default_rng(seed)
    npix = 12 * nside ** 2
    h = np.pi / (2 * nside)
    theta, phi = (x.numpy() for x in thp.pix2ang(
        nside, torch.arange(npix, dtype=torch.int32)))
    vec = np.stack([np.sin(theta) * np.cos(phi),
                    np.sin(theta) * np.sin(phi), np.cos(theta)], 1)
    centres = rng.normal(size=(12, 3))
    if polar:
        centres[0], centres[1] = (0, 0, 1), (0, 0, -1)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    po = np.zeros((npix, 2))
    for k, c in enumerate(centres):
        near = vec @ c > np.cos(8 * h)
        amp = 3.0 * h if k < 2 else 0.1 * h
        po[near] += amp * rng.uniform(-1, 1, (near.sum(), 2))
    return po, rng.exponential(1.0, npix)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside,polar", [(64, True), (256, False)],
                         ids=["nside64-poles", "nside256"])
def test_stencil_weights_match_plain(nside, polar, dt):
    """The weight tables' sum in the kernel's order is bitwise the plain
    stencil's: with the path's exclusions (hot and geometric tiles), and
    with only the hot tiles excluded (the stencil then also runs the
    geometric tiles, with their rows through the poles)."""
    po, orig = _offsets(nside, polar)
    tiling = tt.SkyTiling(nside)
    tables = ts.stencil_tables(tiling, tt.stencil_host_info(tiling), "cpu")
    po_t = tiling.tile_view(torch.as_tensor(po).to(dt))
    og_t = tiling.tile_view(torch.as_tensor(orig).to(dt))
    excl = ts.hot_tiles(po_t, tables)
    # the tiles the hot test finds by their offsets alone
    hot = ts.hot_tiles(po_t, dict(tables, D_geom=torch.zeros_like(
        tables["D_geom"])))
    assert hot.any() and not hot.all() and tables["D_geom"].any()
    RB, D = tiling.RB, 2 * tables["W"] + 1
    for ex in (excl, hot):
        want = ts.stencil_regrid_plain(tiling, tables, po_t, og_t, ex)
        got, w = ts.stencil_weights_plain(tiling, tables, po_t, og_t, ex)
        assert torch.equal(got, want)
        # at NSIDE 64 every tile is geometric: the path excludes them all
        assert (ex is excl) or want.abs().max() > 0
        n = tiling.n_tiles
        assert w["r0"].shape == w["rat"].shape == (n, RB, D)
        assert w["wth"].shape == (n, RB, D, tiling.K + 2 * tables["Wc"])
        assert w["wth"].dtype == w["y"].dtype == dt
        # some tap rows carry no weight at all
        assert 0 < w["live"].double().mean() < 1
        # the zero-offset relations are exact integers on the own row
        assert bool((w["r0"][:, :, D // 2] == 0).all())
        assert bool((w["rat"][:, :, D // 2] == 1).all())


# ---- K19 -----------------------------------------------------------------
@pytest.mark.parametrize("nside", [8, 16, 48, 64, 1024])
def test_ring_heights_mirrored(nside):
    """Caps bitwise the JAX heights, the south belt exactly the negated
    north, everything within 2.2e-16 of the JAX heights."""
    z = sht.ring_heights(nside)
    zj = jsht._ring_geometry(nside)[2]
    i = np.arange(1, 4 * nside)
    cap = (i < nside) | (i > 3 * nside)
    np.testing.assert_array_equal(z[cap], zj[cap])
    assert np.array_equal(z, -z[::-1])
    assert np.abs(z - zj).max() <= 2.2205e-16
    # the north belt and the equator as the JAX formula gives them
    north = (i >= nside) & (i <= 2 * nside)
    np.testing.assert_array_equal(z[north], zj[north])
    assert z[2 * nside - 1] == 0.0


def test_legendre_parity_bitwise():
    """lambda_lm(-z) = (-1)^(l-m) lambda_lm(z), bitwise, in the plain
    recurrence at NSIDE 64 (lmax 191)."""
    nside, lmax = 64, 191
    z = torch.as_tensor(sht.ring_heights(nside))
    m = torch.arange(lmax + 1)
    n_rows = 0
    for (li, a), (_, b) in zip(sht._legendre_rows(z, lmax),
                               sht._legendre_rows(-z, lmax)):
        sign = torch.where((li - m) % 2 == 0, 1.0, -1.0).double()
        assert torch.equal(b, sign * a)
        n_rows += 1
    assert n_rows == lmax + 1


@pytest.mark.parametrize("nside", [8, 48, 64, 1024, 2048])
@pytest.mark.parametrize("heights", ["mirrored", "jax"])
def test_mirror_pairs_cover_each_ring_once(nside, heights):
    z = (sht.ring_heights(nside) if heights == "mirrored"
         else jsht._ring_geometry(nside)[2])
    chains = sht.mirror_pairs(z)
    rings = chains[chains >= 0]
    assert np.array_equal(np.sort(rings), np.arange(z.size))
    assert (np.diff(chains[:, 0]) > 0).all()
    paired = chains[:, 1] >= 0
    assert (chains[paired, 1] == z.size - 1 - chains[paired, 0]).all()
    assert np.array_equal(z[chains[paired, 1]], -z[chains[paired, 0]])
    n_exact = int((z == -z[::-1]).sum())
    if heights == "mirrored":
        assert len(chains) == 2 * nside           # 2N - 1 pairs, the equator
    else:
        # the exact mirrors pair (the equator alone), the rest alone
        assert len(chains) == z.size - (n_exact - 1) // 2


@pytest.mark.parametrize("nside", [8, 16, 32, 64])
@pytest.mark.parametrize("heights", ["mirrored", "jax"])
def test_legendre_pairs_match_plain(nside, heights):
    """The E/O contraction over the chains within K19's tolerance of the
    ring-by-ring plain version."""
    lmax = 3 * nside - 1
    z = torch.as_tensor(sht.ring_heights(nside) if heights == "mirrored"
                        else jsht._ring_geometry(nside)[2])
    g = np.random.default_rng(nside)
    fr, fi = (torch.as_tensor(g.standard_normal((z.numel(), lmax + 1)))
              for _ in range(2))
    pr, pi = sht.legendre_alm_plain(z, fr, fi, lmax)
    sr, si = sht.legendre_alm_plain(z, fr, fi, lmax, absolute=True)
    qr, qi = sht.legendre_alm_pairs_plain(z, fr, fi, lmax)
    tol = 4 * z.numel() * EPS
    for q, p, s in ((qr, pr, sr), (qi, pi, si)):
        assert float(((q - p).abs() - tol * s).max()) <= 0
        assert bool((q.tril(-1) == 0).all())


def test_mirrored_heights_move_little():
    """The plain version on the mirrored and on the JAX heights, NSIDE 64,
    lmax 191: within a tenth of K19's tolerance."""
    nside, lmax = 64, 191
    z = torch.as_tensor(sht.ring_heights(nside))
    zj = torch.as_tensor(jsht._ring_geometry(nside)[2])
    g = np.random.default_rng(7)
    fr, fi = (torch.as_tensor(g.standard_normal((z.numel(), lmax + 1)))
              for _ in range(2))
    ar, ai = sht.legendre_alm_plain(z, fr, fi, lmax)
    jr, ji = sht.legendre_alm_plain(zj, fr, fi, lmax)
    sr, si = sht.legendre_alm_plain(z, fr, fi, lmax, absolute=True)
    tol = 4 * z.numel() * EPS
    assert float(((ar - jr).abs() / (sr + 1e-300)).max()) <= tol / 10
    assert float(((ai - ji).abs() / (si + 1e-300)).max()) <= tol / 10
    assert not torch.equal(ar, jr)                 # the heights did move
