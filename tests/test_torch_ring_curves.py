"""The layouts of kernels K3 (scatter regrid) and K1 (curve collapse) on the
CPU, against the JAX package.

K3 takes every pixel's colatitude, its ring's phi step and its clamped sin
from a per-ring table (``ops.regrid.ring_table_plain`` is its plain
version): the table's theta must be pix2ang's, bit for bit, for every
pixel of the ring, and within a few ulps of the JAX pix2ang. K1 forms each
halo's corner weights and row offsets once (``ops.interp.
halo_corners_plain``): summed over the corners they give the plain
collapse bit for bit and the JAX ``collapse_curves`` to its tolerances.
The models keep their cast tables and K1's set-up on them between calls
(``ops.interp.cast_copy``, ``curve_table``), and must pick up a table
that ``load_table`` or ``setup_interpolator`` rebuilt.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu.ops import healpix as jhp             # noqa: E402
from baryonforge_tpu.ops import interp as jinterp          # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import healpix as thp           # noqa: E402
from baryonforge_torch.ops import interp as tinterp         # noqa: E402
from baryonforge_torch.ops import regrid as tregrid         # noqa: E402

from test_torch_curves import (TABLE, _halos, p_key_table,  # noqa: E402
                               torch_model)

TDT = {"f32": torch.float32, "f64": torch.float64}
JDT = {"f32": jnp.float32, "f64": jnp.float64}


def _pixel_rings(nside, pix):
    """Each pixel's ring (1 .. 4 nside - 1) by search of the ring starts."""
    r = torch.arange(1, 4 * nside, dtype=torch.int32)
    sp, _, _, _ = thp.ring_info(nside, r)
    return torch.searchsorted(sp.long(), pix.long(), right=True) - 1


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("nside", [1, 2, 64, 1024])
def test_ring_table_is_pix2ang(nside, dt):
    """Every pixel's theta from K3's ring table equals pix2ang's bit for
    bit (NSIDE 1024: each ring's first, middle and last pixel), its sin
    clamped as displaced_weights clamps it, the phi step 2 pi / nr rounded
    once from float64; theta within 4 ulps of the JAX pix2ang's."""
    tdt = TDT[dt]
    theta, dphi, sin_safe = tregrid.ring_table_plain(nside, tdt)
    assert theta.dtype == dphi.dtype == sin_safe.dtype == tdt
    assert theta.shape == (4 * nside - 1,)
    r = torch.arange(1, 4 * nside, dtype=torch.int32)
    sp, nr, _, _ = thp.ring_info(nside, r)
    if nside <= 64:
        pix = torch.arange(thp.npix(nside), dtype=torch.int32)
    else:
        pix = torch.unique(torch.cat([sp, sp + nr // 2, sp + nr - 1]))
    ring = _pixel_rings(nside, pix)
    tp, _ = thp.pix2ang(nside, pix, tdt)
    assert torch.equal(theta[ring], tp)
    sin_t = torch.sin(tp)
    assert torch.equal(sin_safe[ring],
                       torch.where(sin_t > 1e-12, sin_t,
                                   torch.ones_like(sin_t)))
    np.testing.assert_array_equal(
        dphi.numpy(), (2 * np.pi / nr.numpy().astype(np.float64)).astype(
            np.float32 if dt == "f32" else np.float64))
    jt, _ = jhp.pix2ang(nside, jnp.asarray(pix.numpy()), JDT[dt])
    jt = np.asarray(jt)
    eps = np.finfo(jt.dtype).eps
    assert (np.abs(theta[ring].numpy() - jt) <= 4 * eps * np.abs(jt)).all()


@pytest.mark.parametrize("n_p", [0, 1, 2])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_halo_corners_match_jax(n_p, dt):
    """K1's per-halo step: the corners' weights and row offsets summed in
    order rebuild the plain collapse bit for bit, and the JAX
    collapse_curves (float64 to rtol 1e-12, float32 to 1e-6 with an
    absolute floor at that fraction of the largest value); out-of-table
    rows are flagged; a single a (a scalar) gives the expanded a's curves."""
    table, axes, M, a, p = p_key_table(n_p, seed=31)
    tdt = TDT[dt]
    keys = sorted(p)
    tt = torch.as_tensor(table, dtype=tdt)
    tax = tuple(torch.as_tensor(x, dtype=tdt) for x in axes)
    for a_use in (a, float(a[7])):
        w, off, stride_r, oob = tinterp.halo_corners_plain(
            tt, tax, 2, M, a_use, keys, p)
        assert w.shape == off.shape == (M.size, 2 ** (2 + n_p))
        r = torch.arange(table.shape[2]) * stride_r
        rows = tt.reshape(-1)[off[:, :, None] + r]
        rebuilt = torch.zeros((M.size, table.shape[2]), dtype=tdt)
        for c in range(w.shape[1]):
            rebuilt = rebuilt + w[:, c:c + 1] * rows[:, c]
        rebuilt = torch.where(oob[:, None], torch.full_like(rebuilt, -3.0),
                              rebuilt)
        plain = tinterp.collapse_curves_plain(tt, tax, 2, M, a_use, keys, p,
                                              fill=-3.0)[0]
        assert torch.equal(rebuilt, plain)
        jc = np.asarray(jinterp.collapse_curves(
            jnp.asarray(table, JDT[dt]),
            tuple(jnp.asarray(x, JDT[dt]) for x in axes), 2, M, a_use, keys,
            p, fill=-3.0)[0])
        rtol = 1e-12 if dt == "f64" else 1e-6
        np.testing.assert_allclose(rebuilt.numpy(), jc, rtol=rtol,
                                   atol=rtol * np.abs(jc).max())
        assert oob.numpy().tolist() == (jc == -3.0).all(axis=1).tolist()
        assert oob[0] and oob.sum() >= 2 + n_p - (a_use is not a)
    scalar = tinterp.halo_corners_plain(tt, tax, 2, M, float(a[7]), keys,
                                        p)[0]
    expanded = tinterp.halo_corners_plain(tt, tax, 2, M,
                                          np.full(M.size, a[7]), keys, p)[0]
    assert torch.equal(scalar, expanded)


def test_curve_scalars_are_floats():
    """collapse_curves and halo_curves give ln_r0 and dlnr as Python
    floats, the table dtype's first radial point and step."""
    M, a = _halos(n=20, seed=3)
    for dt in (torch.float32, torch.float64):
        m = torch_model().with_dtype(dt)
        c, r0, dl = m.halo_curves(M, a)
        ax = m._axes[2]
        assert type(r0) is float and type(dl) is float
        assert r0 == float(ax[0]) and dl == float(ax[1] - ax[0])
        c2, r2, d2 = tinterp.collapse_curves(m._table, m._axes, 2, M, a, [],
                                             {})
        assert torch.equal(c, c2) and (r2, d2) == (r0, dl)
    with pytest.raises(ValueError, match="values of an axis"):
        tinterp.collapse_curves(m._table, m._axes, 2, M, a[:3], [], {})


def test_halo_curves_follow_a_reloaded_table(tmp_path):
    """A model's cast table and its K1 set-up are kept between calls (the
    same objects in every copy), and a table rebuilt after the first call
    is picked up: load_table of another file, then load_table and
    setup_interpolator back; each time the copy's curves equal a fresh
    model's."""
    M, a = _halos(n=40, seed=5)
    m = torch_model()
    c1 = m.with_dtype(torch.float32).halo_curves(M, a)[0]
    copy1 = m.with_dtype(torch.float32)
    again = m.with_dtype(torch.float32)
    assert again._table is copy1._table and again._axes is copy1._axes
    ct = tinterp.curve_table(copy1, "_table")
    assert ct is tinterp.curve_table(again, "_table")
    assert ct.table is copy1._table
    with np.load(TABLE, allow_pickle=True) as f:
        other = {k: f[k] for k in f.files}
    other["d"] = other["d"] * 2.0 + 0.25
    path = tmp_path / "other.npz"
    np.savez(path, **other)
    m.load_table(path)
    c2 = m.with_dtype(torch.float32).halo_curves(M, a)[0]
    fresh = torch_model().load_table(path).with_dtype(torch.float32)
    assert torch.equal(c2, fresh.halo_curves(M, a)[0])
    assert not torch.equal(c2, c1)
    assert m.with_dtype(torch.float32)._table is not copy1._table
    assert tinterp.curve_table(m.with_dtype(torch.float32),
                               "_table") is not ct
    m.load_table(TABLE)
    assert torch.equal(m.with_dtype(torch.float32).halo_curves(M, a)[0], c1)
    # the copy's other attributes follow the model's
    m.epsilon_max = 7
    assert m.with_dtype(torch.float32).epsilon_max == 7


def _nfw_table():
    """A small TabulatedProfile on the CPU (no table yet) and its grid."""
    cosmo = bf.cosmo.cosmology_from_dict(dict(
        Omega_m=0.30, Omega_b=0.045, h=0.7, sigma8=0.8, n_s=0.96, w0=-1.0))
    nfw = bf.Profiles.DarkMatterOnly(
        theta_ej=4, theta_co=0.1, M_c=1e14 / 0.7, mu_beta=0.4, eta=0.3,
        eta_delta=0.3, tau=-1.5, tau_delta=0, A=0.09 / 2, M1=2.5e11 / 0.7,
        epsilon_h=0.015, a=0.3, n=2, epsilon=4, p=0.3, q=0.707, gamma=2,
        delta=7, proj_cutoff=100)
    grid = dict(z_min=0.7, z_max=1.1, N_samples_z=2, M_min=1e13,
                M_max=1e15, N_samples_Mass=3, R_min=1e-2, R_max=10,
                N_samples_R=8, verbose=False)
    return bf.utils.TabulatedProfile(nfw, cosmo, device="cpu"), grid


def test_tabulated_curves_follow_a_rebuilt_table():
    """A TabulatedProfile's kept copy picks up tables that
    setup_interpolator rebuilt after the first call."""
    tab, grid = _nfw_table()
    M, a = np.array([2e13, 3e14]), np.array([0.52, 0.55])
    tab.setup_interpolator(**grid)
    c1 = tab.with_dtype(torch.float64).halo_curves(M, a)[0]
    tab.setup_interpolator(**dict(grid, R_max=20))
    c2, r0, dl = tab.with_dtype(torch.float64).halo_curves(M, a)
    assert r0 == float(tab._axes[2][0]) and dl == float(tab._axes[2][1]
                                                        - tab._axes[2][0])
    want = tinterp.collapse_curves_plain(tab._tab2D, tab._axes, 2, M, a, [],
                                         {}, fill=-np.inf)[0]
    assert torch.equal(c2, want) and not torch.equal(c1, c2)


def test_tabulated_casts_are_kept():
    """A TabulatedProfile's copies share one cast of its axes and tables a
    (dtype, device) and one K1 set-up a table (the projected and the real
    apart), whose curves are the plain collapse's and whose radial scalars
    are the cast axis' own."""
    tab, grid = _nfw_table()
    tab.setup_interpolator(**grid)
    M, a = np.array([2e13, 3e14, 9e14]), np.array([0.52, 0.55, 0.6])
    c1, c2 = tab.with_dtype(torch.float32), tab.with_dtype(torch.float32)
    assert c1._tab2D.dtype == torch.float32
    assert (c1._axes is c2._axes and c1._tab2D is c2._tab2D
            and c1._tab3D is c2._tab3D)
    ct2 = tinterp.curve_table(c1, "_tab2D")
    ct3 = tinterp.curve_table(c1, "_tab3D")
    assert ct2 is tinterp.curve_table(c2, "_tab2D") and ct3 is not ct2
    assert ct2.table is c1._tab2D and ct3.table is c1._tab3D
    for kind, table in (("projected", c1._tab2D), ("real", c1._tab3D)):
        got, r0, dl = c2.halo_curves(M, a, kind=kind)
        want = tinterp.collapse_curves_plain(table, c1._axes, 2, M, a, [],
                                             {}, fill=-np.inf)[0]
        assert torch.equal(got, want)
        ax = c1._axes[2]
        assert r0 == float(ax[0]) and dl == float(ax[1] - ax[0])
    assert tab.with_dtype(torch.float64)._tab2D is not c1._tab2D


def test_regrid_wrapper_on_cpu():
    """On CPU tensors the K3 wrapper is its plain version (no launch)."""
    nside = 4
    rng = np.random.default_rng(2)
    po = torch.as_tensor(rng.normal(0, 0.05, (thp.npix(nside), 2)))
    orig = torch.as_tensor(rng.exponential(1.0, thp.npix(nside)))
    _build.reset_launches()
    out = tregrid.regrid(nside, po, orig)
    assert not _build.launches
    assert torch.equal(out, tregrid.regrid_plain(nside, po, orig))
