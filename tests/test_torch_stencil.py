"""Stencil phase B of the torch port (plain versions of kernels K5 and K6,
with K7's views) against the JAX runner's stencil pieces: the fused
hot-tile test and stencil (``_get_stencil_combo``), the tiled original
(``_get_origtiled_jit``) and the complement with its flat view
(``_stencil_complement``), run unchanged.

Offsets are made from a seed: small moves (a tenth of a pixel) around
some centres, a few tiles' worth of large moves (hot tiles), zeros
elsewhere. At NSIDE 64 every block is within 128 rings of a pole, so every
tile is geometric and the complement does everything; at NSIDE 256 the
belt's tiles go through the stencil. float64 throughout: atol 1e-9 of the
largest pixel change (tests/test_tiled_deposit.py:80), the excluded tiles
equal to JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Runners as JRunners             # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import healpix as thp           # noqa: E402
from baryonforge_torch.ops import stencil as ts             # noqa: E402
from baryonforge_torch.ops import tiles as tt               # noqa: E402
from baryonforge_torch.ops.regrid import regrid_plain       # noqa: E402

from test_torch_curves import jax_model                     # noqa: E402
from test_torch_deposit import make_inputs                  # noqa: E402


def stencil_inputs(nside, seed=41):
    """(npix, 2) offsets and the (npix,) map, float64 numpy."""
    rng = np.random.default_rng(seed)
    npix = 12 * nside ** 2
    h = np.pi / (2 * nside)                       # ~ the ring spacing
    theta, phi = (x.numpy() for x in thp.pix2ang(
        nside, torch.arange(npix, dtype=torch.int32)))
    vec = np.stack([np.sin(theta) * np.cos(phi),
                    np.sin(theta) * np.sin(phi), np.cos(theta)], 1)
    po = np.zeros((npix, 2))
    centres = rng.normal(size=(12, 3))
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    for k, c in enumerate(centres):
        near = vec @ c > np.cos(8 * h)
        amp = 3.0 * h if k < 2 else 0.1 * h       # two hot patches
        po[near] += amp * rng.uniform(-1, 1, (near.sum(), 2))
    return po, rng.exponential(1.0, npix)


@pytest.fixture(scope="module", params=[16, 64, 256],
                ids=["nside16", "nside64", "nside256"])
def case(request):
    nside = request.param
    npix = 12 * nside ** 2
    po, orig = stencil_inputs(nside)
    tiling = tt.SkyTiling(nside)
    po_tiled = tiling.tile_view(torch.as_tensor(po))
    cat, shell = make_inputs(nside, 10)
    jr = JRunners.BaryonifyShell(cat, shell, epsilon_max=20,
                                 model=jax_model(), verbose=False)
    rdt = jnp.float64
    combo = jr._get_stencil_combo(nside, rdt)
    og_j = jr._get_origtiled_jit(nside, rdt)(jnp.asarray(orig))
    acc_j = jnp.asarray(po_tiled.numpy())
    out_tiled, excl = combo(acc_j, og_j)
    final = jr._stencil_complement(nside, npix, rdt, acc_j, out_tiled, og_j,
                                   excl)
    ref = dict(out_tiled=np.asarray(out_tiled), excl=np.asarray(excl),
               final=np.asarray(final))
    return nside, tiling, po, orig, po_tiled, ref


def _port(tiling, po_tiled, orig):
    tables = ts.stencil_tables(tiling, tt.stencil_host_info(tiling), "cpu")
    og_t = tiling.tile_view(torch.as_tensor(orig))
    excl = ts.hot_tiles(po_tiled, tables)
    out_tiled = ts.stencil_regrid(tiling, tables, po_tiled, og_t, excl)
    hot = torch.nonzero(excl & ~tables["D_geom"])[:, 0].to(torch.int32)
    geo = ts.stencil_geo(tiling, tables, torch.float64)
    final = ts.stencil_complement(tiling, tiling.flat_view(out_tiled),
                                  po_tiled, og_t, geo, hot)
    return tables, excl, out_tiled, final


def test_stencil_matches_jax(case):
    nside, tiling, po, orig, po_tiled, ref = case
    _build.reset_launches()
    tables, excl, out_tiled, final = _port(tiling, po_tiled, orig)
    assert not _build.launches          # CPU tensors: the plain versions
    np.testing.assert_array_equal(excl.numpy(), ref["excl"])
    hot = excl.numpy() & ~tables["D_geom"].numpy()
    if nside >= 256:
        # the stencil handles most tiles, and the hot patches were found
        assert (~excl).sum() > 0.5 * tiling.n_tiles
        assert hot.any()
    else:
        assert excl.all() and not hot.any()
    scale = np.abs(ref["final"] - orig).max()
    assert scale > 0
    np.testing.assert_allclose(out_tiled.numpy(), ref["out_tiled"], rtol=0,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(final.numpy(), ref["final"], rtol=0,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(final.sum().item(), orig.sum(), rtol=1e-12)


def test_stencil_matches_scatter_regrid(case):
    """The stencil and its complement give the scatter regrid's map for
    the same offsets (tests/test_tiled_deposit.py:66-95)."""
    nside, tiling, po, orig, po_tiled, ref = case
    final = _port(tiling, po_tiled, orig)[3].numpy()
    scatter = regrid_plain(nside, torch.as_tensor(po),
                           torch.as_tensor(orig)).numpy()
    scale = np.abs(scatter - orig).max()
    np.testing.assert_allclose(final, scatter, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("nside", [8, 16, 64, 256])
def test_stencil_geo_matches_jax(nside):
    """The complement's geometric source list (slot ids and pixels) equals
    the JAX list; each source's angles, from its pixel and the ring table
    (``source_angles_plain``, as K6 forms them), equal the JAX list's bit
    for bit: phi in both dtypes, theta in float32. In float64 theta is
    torch's ring_theta against XLA's, a few ulps apart (asin, acos), and
    is held to 4 ulps."""
    tiling = tt.SkyTiling(nside)
    cat, shell = make_inputs(nside, 10)
    jr = JRunners.BaryonifyShell(cat, shell, epsilon_max=20,
                                 model=jax_model(), verbose=False)
    jr._get_stencil_combo(nside, jnp.float64)
    tables = ts.stencil_tables(tiling, tt.stencil_host_info(tiling), "cpu")
    sf_j = np.asarray(jr._get_stencil_geo(nside))
    for jdt, tdt in ((jnp.float64, torch.float64),
                     (jnp.float32, torch.float32)):
        sf, pix, rows = ts.stencil_geo(tiling, tables, tdt)
        jpix, jth, jph = (np.asarray(x) for x in
                          jr._get_stencil_geo_ang(nside, jdt))
        np.testing.assert_array_equal(sf.numpy(), sf_j)
        np.testing.assert_array_equal(pix.numpy(), jpix)
        th, ph = ts.source_angles_plain(nside, pix, rows)
        assert th.dtype == ph.dtype == rows.dtype == tdt
        np.testing.assert_array_equal(ph.numpy(), jph)
        if tdt == torch.float32:
            np.testing.assert_array_equal(th.numpy(), jth)
        else:
            np.testing.assert_allclose(th.numpy(), jth, rtol=4 * 2.0 ** -52,
                                       atol=0)
    assert sf.numel() == int(tables["g_off"][-1])


@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("nside", [8, 16])
def test_stencil_ring_table_forms(nside, dt):
    """K6's ring table (``stencil_rings_plain``): the target form is K3's
    table (pix2ang's theta, bit for bit, for every pixel of the ring), the
    source form the float64 ring_theta rounded to the dtype; both phi
    steps 2 pi / nr rounded once; the forms coincide in float64."""
    rows = ts.stencil_rings_plain(nside, dt).reshape(2, 4 * nside, 4)
    assert rows.dtype == dt
    assert torch.equal(rows[:, 0], torch.zeros_like(rows[:, 0]))
    assert torch.equal(rows[..., 3], torch.zeros_like(rows[..., 3]))
    pix = torch.arange(thp.npix(nside), dtype=torch.int32)
    ring = thp.pixel_ring(nside, pix).long()
    tp, _ = thp.pix2ang(nside, pix, dt)
    assert torch.equal(rows[0, ring, 0], tp)
    t64, _ = thp.pix2ang(nside, pix, torch.float64)
    assert torch.equal(rows[1, ring, 0], t64.to(dt))
    assert torch.equal(rows[0, :, 1], rows[1, :, 1])
    if dt == torch.float64:
        assert torch.equal(rows[0], rows[1])
