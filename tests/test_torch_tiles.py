"""Sky tiling of the torch port against baryonforge_tpu.ops.tiles.

Host arrays (the tiling's per-tile arrays, the halo pairs, count_valid_slots
and the stencil's host tables) must be equal. The device geometry runs at
NSIDE 32, 64 and 256 and on an 8 x 16 tiling: integers equal, float64 to
rtol 1e-12, float32 to atol 2e-6, and the plain version of kernel K4's
per-row layout (``ops.tile_deposit.slot_geometry_plain``) must equal
``slot_local`` bit for bit; the re-layouts (plain versions of kernel K7)
move values and must give equal arrays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu.ops import tiles as jt                 # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import tiles as tt               # noqa: E402
from baryonforge_torch.ops.tile_deposit import (            # noqa: E402
    row_geometry_plain, slot_geometry_plain)

CASES = [(32, 16, 32), (64, 16, 32), (256, 16, 32), (64, 8, 16)]
IDS = ["nside32", "nside64", "nside256", "nside64-8x16"]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def tilings(request):
    nside, rb, k = request.param
    return jt.SkyTiling(nside, rb, k), tt.SkyTiling(nside, rb, k)


def _tile_cols(t, tids):
    return (torch.as_tensor(t.tile_i0[tids], dtype=torch.int32),
            torch.as_tensor(t.tile_s[tids], dtype=torch.int32),
            torch.as_tensor(t.tile_S[tids], dtype=torch.int32))


def _tids(t):
    """Every tile at the small NSIDEs; at NSIDE 256 every third tile plus
    the first and last blocks (the caps)."""
    tids = np.arange(t.n_tiles)
    if t.nside >= 256:
        caps = (t.tile_block < 2) | (t.tile_block >= t.n_blocks - 2)
        tids = tids[(tids % 3 == 0) | caps]
    return tids


def test_tiling_arrays_equal(tilings):
    j, t = tilings
    assert (t.n_tiles, t.n_blocks, t.RB, t.K) == (j.n_tiles, j.n_blocks,
                                                  j.RB, j.K)
    for name in ("S", "i0", "tile_off", "tile_block", "tile_s", "tile_i0",
                 "tile_S", "block_th_lo", "block_th_hi", "tile_center",
                 "_belt_exact", "tile_crad", "center_sincos"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_slot_local_matches_jax(tilings, dt):
    j, t = tilings
    jdt, tdt = ((jnp.float64, torch.float64) if dt == "f64"
                else (jnp.float32, torch.float32))
    tids = _tids(t)
    csc = t.center_sincos[tids]
    jout = jax.jit(jax.vmap(lambda i0, s, S, c: j.slot_local(
        i0, s, S, c, dtype=jdt, tangent=True)))(
        j.tile_i0[tids].astype(np.int32), j.tile_s[tids].astype(np.int32),
        j.tile_S[tids].astype(np.int32), csc)
    tout = t.slot_local(*_tile_cols(t, tids), torch.as_tensor(csc), tdt,
                        tangent=True)
    names = ("dp", "valid", "e_th", "e_ph", "a_th", "a_ph")
    for name, a, b in zip(names, tout, jout):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        if name == "valid":
            np.testing.assert_array_equal(a.numpy(), b)
        elif dt == "f64":
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-15,
                                       err_msg=name)
        else:
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-6,
                                       err_msg=name)
    dp, valid = t.slot_local(*_tile_cols(t, tids), torch.as_tensor(csc), tdt)
    assert torch.equal(dp, tout[0]) and torch.equal(valid, tout[1])
    # K4's layout: the ring values once a (tile, row), each slot's from
    # them, the azimuth wrapped by the exact remainder: bitwise slot_local,
    # polar tiles with rows off the sphere included
    rows = slot_geometry_plain(t, torch.as_tensor(tids), tdt)
    for name, a, b in zip(names, rows, tout):
        assert torch.equal(a, b), name
    ok = row_geometry_plain(t, torch.as_tensor(tids))["ok"]
    assert not ok.all() and ok.any(dim=1).all()


def test_slot_pixels_and_index_match_jax(tilings):
    j, t = tilings
    tids = _tids(t)
    cols = [j.tile_i0[tids].astype(np.int32), j.tile_s[tids].astype(np.int32),
            j.tile_S[tids].astype(np.int32)]
    jpix, jphi, jvalid, jth = jax.jit(jax.vmap(j.slot_pixels))(*cols)
    pix, phi, valid, th = t.slot_pixels(*_tile_cols(t, tids))
    np.testing.assert_array_equal(pix.numpy(), np.asarray(jpix))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=1e-12)
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=1e-12)
    jpix2, jvalid2 = jax.jit(jax.vmap(j.slot_pix))(*cols)
    pix2, valid2 = t.slot_pix(*_tile_cols(t, tids))
    np.testing.assert_array_equal(pix2.numpy(), np.asarray(jpix2))
    np.testing.assert_array_equal(valid2.numpy(), np.asarray(jvalid2))

    npix = 12 * t.nside ** 2
    lin = t.slot_index(torch.arange(npix, dtype=torch.int32))
    jlin = jax.jit(j.slot_index)(jnp.arange(npix, dtype=jnp.int32))
    assert lin.dtype == torch.int32
    np.testing.assert_array_equal(lin.numpy(), np.asarray(jlin))
    # every pixel has its own valid slot
    assert np.unique(lin.numpy()).size == npix


@pytest.mark.parametrize("trail", [(), (2,)], ids=["map", "offsets"])
def test_views_match_jax(tilings, trail):
    j, t = tilings
    rng = np.random.default_rng(3)
    npix = 12 * t.nside ** 2
    flat = rng.normal(size=(npix,) + trail)
    _build.reset_launches()
    tiled = t.tile_view(torch.as_tensor(flat))
    np.testing.assert_array_equal(
        tiled.numpy(), np.asarray(jax.jit(j.tile_view)(jnp.asarray(flat))))
    back = t.flat_view(tiled)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jax.jit(j.flat_view)(jnp.asarray(tiled.numpy()))))
    np.testing.assert_array_equal(back.numpy(), flat)
    assert not _build.launches          # CPU tensors: the plain versions
    acc = rng.normal(size=(t.n_tiles, t.P) + trail).astype(np.float32)
    np.testing.assert_array_equal(
        t.flat_view(torch.as_tensor(acc)).numpy(),
        np.asarray(jax.jit(j.flat_view)(jnp.asarray(acc))))


def _halos(nside, n=120, seed=9):
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, n))
    theta[:2] = [0.004, np.pi - 0.004]
    phi = rng.uniform(0, 2 * np.pi, n)
    radius = rng.uniform(0.5, 6.0, n) * np.pi / (2 * nside)
    return theta, phi, radius


def test_halo_pairs_equal(tilings):
    """bin_halos_to_tiles and refine_pairs give the JAX pairs, and
    pairs_csr groups them per tile as bucket_tiles does."""
    j, t = tilings
    theta, phi, radius = _halos(t.nside)
    jt_ids, jh_ids = jt.bin_halos_to_tiles(j, theta, phi, radius)
    t_ids, h_ids = tt.bin_halos_to_tiles(t, theta, phi, radius)
    np.testing.assert_array_equal(t_ids, jt_ids)
    np.testing.assert_array_equal(h_ids, jh_ids)
    st = np.sin(theta)
    vh = np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], 1)
    chord = 2.0 * np.sin(np.minimum(radius, np.pi) / 2.0)
    _, (jtk, jhk) = jt.refine_pairs(j, jt_ids, jh_ids, vh, chord)
    tk, hk = tt.refine_pairs(t, t_ids, h_ids, vh, chord)
    np.testing.assert_array_equal(tk, jtk)
    np.testing.assert_array_equal(hk, jhk)
    assert tk.size < t_ids.size             # the prune dropped pairs

    tiles, offsets, halos = tt.pairs_csr(tk, hk)
    rows = {}
    for tb, hidx in jt.bucket_tiles(jtk, jhk):
        for tile, row in zip(tb, hidx):
            rows[int(tile)] = row[row >= 0]
    assert sorted(rows) == tiles.tolist()
    for k, tile in enumerate(tiles):
        np.testing.assert_array_equal(halos[offsets[k]:offsets[k + 1]],
                                      rows[int(tile)])


def test_stencil_host_info_equal(tilings):
    j, t = tilings
    ji, ti = jt.stencil_host_info(j), tt.stencil_host_info(t)
    assert sorted(ti) == sorted(ji)
    for k in ji:
        np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    tids = np.random.default_rng(4).choice(t.n_tiles, min(50, t.n_tiles),
                                           replace=False)
    assert tt.count_valid_slots(t, tids) == jt.count_valid_slots(j, tids)
    g = np.where(ti["D_geom"])[0]
    assert tt.valid_slot_counts(t, g).sum() == jt.count_valid_slots(j, g)


def test_tiling_rejects_large_nside():
    with pytest.raises(ValueError, match="NSIDE"):
        tt.SkyTiling(16384)
