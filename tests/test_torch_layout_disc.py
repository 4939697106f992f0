"""The layouts that kernels K7 (tile layout) and K2 (disc deposit) walk,
checked on the CPU against the port's plain versions (torch only).

K7 copies each (tile, row) segment: ``tile_view`` reads the live slots'
pixels, and ``flat_view`` writes only live slots, so it relies on the live
slots covering every pixel exactly once. That is checked here for the
shell's 16 x 32 and the paint's 8 x 16 tilings, from the per-row segments
(``SkyTiling._segments``, the plain twin of csrc/tiles.cuh:
tile_segment), with the two plain views each other's inverse.

K2 lays a disc out as its rings, each ring's phi span, and one flat
(ring, dp) index (``deposit.disc_walk_plain``). Its members must be the
members of the padded windows of ``disc_deposit_plain``
(``deposit.disc_members_plain``), and a disc of more than
``SPLIT_RINGS`` rings, whose members the kernel does not count, must
have at least 4.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import deposit                   # noqa: E402
from baryonforge_torch.ops import tiles as tt               # noqa: E402

TABLE = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                     "_northstar_table.npz")
COSMO = dict(Omega_m=0.30, Omega_b=0.045, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
TILINGS = [(16, 32), (8, 16)]
TILING_IDS = ["shell", "paint"]
DTYPES = [torch.float64, torch.float32]
DT_IDS = ["f64", "f32"]


# -- K7 -----------------------------------------------------------------

def _live_pixels(tiling):
    """Every live slot's pixel (int64), in tile-major slot order, and the
    live mask (n_tiles, RB, K), from the per-row segments."""
    arr = tiling.device_arrays("cpu")
    ring_ok, _, sp, nr, _, j0, j1 = tiling._segments(
        arr["tile_i0"], arr["tile_s"], arr["tile_S"])
    v = torch.arange(tiling.K, dtype=torch.int32)
    live = ring_ok[:, :, None] & (v < torch.clamp(j1 - j0, max=tiling.K)
                                  [:, :, None])
    j = j0[:, :, None] + v
    jw = torch.where(j < nr[:, :, None], j, j - nr[:, :, None])
    return (sp[:, :, None] + jw)[live].long(), live


@pytest.mark.parametrize("shape", TILINGS, ids=TILING_IDS)
@pytest.mark.parametrize("nside", [64, 256, 1024])
def test_live_slots_cover_each_pixel_once(nside, shape):
    tiling = tt.SkyTiling(nside, *shape)
    pix, live = _live_pixels(tiling)
    assert pix.numel() == tiling.npix
    assert torch.equal(torch.bincount(pix, minlength=tiling.npix),
                       torch.ones(tiling.npix, dtype=torch.int64))
    # the segments' live slots are slot_pix's valid slots, pixel for pixel
    arr = tiling.device_arrays("cpu")
    sp_pix, valid = tiling.slot_pix(arr["tile_i0"], arr["tile_s"],
                                    arr["tile_S"])
    assert torch.equal(valid, live)
    assert torch.equal(sp_pix[valid].long(), pix)
    # and a pixel's slot index is its live slot's
    lin = torch.nonzero(live.reshape(-1))[:, 0]
    assert torch.equal(
        tiling.slot_index(pix.to(torch.int32)).long(), lin)


@pytest.mark.parametrize("shape", TILINGS, ids=TILING_IDS)
@pytest.mark.parametrize("nside", [64, 256, 1024])
def test_plain_views_are_inverse(nside, shape):
    tiling = tt.SkyTiling(nside, *shape)
    g = torch.Generator().manual_seed(5)
    trail = (2,) if nside == 64 else ()
    flat = torch.randn((tiling.npix,) + trail, dtype=torch.float32,
                       generator=g)
    tv = tiling.tile_view_plain(flat)
    assert torch.equal(tiling.flat_view_plain(tv), flat)
    # dead slots hold exact zeros, live slots their pixel's value
    _, live = _live_pixels(tiling)
    dead = ~live.reshape(tiling.n_tiles, tiling.P)
    assert not tv[dead].any()


# -- K2 -----------------------------------------------------------------

def _polar_halos(nside=64, n=400, seed=7):
    """The NSIDE 64 polar catalog of chip_smoke.py (halos at dec +-89.5,
    near the caps, and a third at the table's lowest masses: discs under 4
    pixels), with one disc moved onto phi = 0: theta, phi, radius."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    dec[2:18] = rng.uniform(77, 84, 16) * rng.choice([-1, 1], 16)
    dec[0], dec[1] = 89.5, -89.5
    M = 10 ** rng.uniform(13.0, 14.8, n)
    M[2::3] = 10 ** rng.uniform(12.71, 12.8, M[2::3].size)
    z = rng.uniform(0.8, 1.0, n)
    cat = bf.utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                        cosmo=COSMO)
    shell = bf.utils.LightconeShell(map=np.ones(12 * nside * nside),
                                    cosmo=COSMO)
    model = bf.Baryonification2D(
        None, None, bf.cosmo.cosmology_from_dict(COSMO), epsilon_max=20,
        device="cpu").load_table(TABLE)
    r = bf.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                          device="cpu")
    hd = r._host_halo_data(bf.cosmo.cosmology_from_dict(r.cosmo))
    h = {k: torch.as_tensor(np.asarray(hd[k], np.float64))
         for k in ("theta", "phi", "radius")}
    return h


def _discs(nside, case):
    """Halo columns of one case: the polar catalog, or single discs."""
    if case == "polar":
        return _polar_halos(nside)
    pix = math.pi / (2 * nside)               # ~ a pixel's width, rad
    th, ph, rad = {
        # a disc across phi = 0, from either side
        "wrap": ([1.1, 2.0], [0.4 * pix, 2 * math.pi - 0.7 * pix],
                 [6 * pix, 3.3 * pix]),
        # through each pole, and one just short of it
        "poles": ([0.3 * pix, math.pi - 0.2 * pix, 4 * pix],
                  [1.0, 4.0, 2.5], [5 * pix, 2.5 * pix, 4.5 * pix]),
        # under 4 members: the fallback
        "small": ([0.9, 1.7, 0.05], [0.3, 5.9, 2.0],
                  [0.3 * pix, 0.6 * pix, 0.4 * pix]),
    }[case]
    return {k: torch.tensor(v, dtype=torch.float64)
            for k, v in zip(("theta", "phi", "radius"), (th, ph, rad))}


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside,case", [(64, "polar"), (64, "wrap"),
                                        (256, "wrap"), (64, "poles"),
                                        (1024, "poles"), (64, "small")])
def test_disc_walk_members_match_plain(nside, case, dt):
    h = _discs(nside, case)
    w = deposit.disc_walk_plain(nside, h["theta"], h["phi"], h["radius"],
                                dt)
    hw, pw = w["halo"][w["member"]], w["pix"][w["member"]]
    order = torch.argsort(hw * (1 << 32) + pw)
    hp, pp = deposit.disc_members_plain(nside, h, dt)
    assert torch.equal(hw[order], hp) and torch.equal(pw[order], pp)
    n = h["theta"].numel()
    counts = torch.bincount(hp, minlength=n)
    if case == "small":
        assert (counts < 4).all()
    else:
        assert (counts >= 4).any()
    # the flat index: each disc's candidates are 0 .. total - 1, in walk
    # order, and no pixel is a candidate twice
    total = w["span"].sum(1)
    start = torch.cumsum(total, 0) - total
    assert torch.equal(w["q"], torch.arange(w["q"].numel())
                       - start[w["halo"]])
    key = w["halo"] * (1 << 32) + w["pix"]
    assert torch.unique(key).numel() == key.numel()


def _split_radii(nside, theta, dt):
    """Per colatitude, the least radius (to 1e-9 rad) at which the disc has
    more than SPLIT_RINGS rings."""
    lo = torch.zeros_like(theta)
    hi = torch.full_like(theta, math.pi)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        big = deposit._ring_range(nside, theta, mid, dt)[1] \
            > deposit.SPLIT_RINGS
        hi = torch.where(big, mid, hi)
        lo = torch.where(big, lo, mid)
    return hi


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [16, 64, 1024])
def test_split_discs_have_4_members(nside, dt):
    """The discs the kernel walks without counting, at the least radius
    that sends them there, on colatitudes from pole to pole (both poles
    included), hold at least 4 members."""
    theta = torch.cat([torch.linspace(0.0, math.pi, 721, dtype=torch.float64),
                       torch.tensor([1e-7, math.pi - 1e-7],
                                    dtype=torch.float64)])
    phi = torch.remainder(theta * 7.3, 2 * math.pi)
    radius = _split_radii(nside, theta, dt)
    w = deposit.disc_walk_plain(nside, theta, phi, radius, dt)
    assert w["block"].all()
    members = torch.bincount(w["halo"][w["member"]],
                             minlength=theta.numel())
    assert int(members.min()) >= 4
