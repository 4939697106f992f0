"""Displacement table of the torch port against baryonforge_tpu: the
per-halo curve collapse (plain version of kernel K1), the readout, the
checkpoint and the conversion of a JAX model.

The table is the bench configuration's Schneider19 Baryonification2D table
(tools/_northstar_table.npz, (8, 20, 64) in float64).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Profiles                       # noqa: E402
from baryonforge_tpu import cosmo as jcosmo                # noqa: E402
from baryonforge_tpu.Profiles.BaryonCorrection import \
    Baryonification2D as JBaryonification2D                 # noqa: E402
from baryonforge_torch.Profiles.BaryonCorrection import \
    Baryonification2D                                       # noqa: E402
from baryonforge_tpu.ops import interp as jinterp          # noqa: E402
from baryonforge_torch.cosmo import core as tcore           # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import interp as tinterp         # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

TABLE = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                     "_northstar_table.npz")
H = 0.7
COSMO_DICT = dict(Omega_m=0.30, Omega_b=0.045, h=H, sigma8=0.8, n_s=0.96,
                  w0=-1.0)
BPAR = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / H, mu_beta=0.4,
            eta=0.3, eta_delta=0.3, tau=-1.5, tau_delta=0,
            A=0.09 / 2, M1=2.5e11 / H, epsilon_h=0.015,
            a=0.3, n=2, epsilon=4, p=0.3, q=0.707, gamma=2, delta=7)


def jax_model(epsilon_max=20):
    """The bench's JAX model with the checked-in table loaded."""
    cosmo = jcosmo.cosmology_from_dict(COSMO_DICT)
    DMO = Profiles.DarkMatterOnly(**BPAR, proj_cutoff=100)
    DMB = Profiles.DarkMatterBaryon(**BPAR, proj_cutoff=100)
    m = JBaryonification2D(DMO, DMB, cosmo, epsilon_max=epsilon_max)
    return m.load_table(TABLE)


def torch_model(epsilon_max=20):
    cosmo = tcore.cosmology_from_dict(COSMO_DICT)
    return Baryonification2D(None, None, cosmo,
                             epsilon_max=epsilon_max).load_table(TABLE)


def _halos(n=300, seed=11):
    """Masses and scale factors inside the table, plus out-of-table rows
    (mass and redshift on both sides) that must come back as zeros."""
    rng = np.random.default_rng(seed)
    M = 10 ** rng.uniform(12.8, 15.2, n)
    z = rng.uniform(0.75, 1.05, n)
    M[:4] = [1e12, 1e16, 1e14, 1e14]
    z[:4] = [0.9, 0.9, 0.2, 3.0]
    return M, 1.0 / (1.0 + z)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_halo_curves_match_jax(dt):
    """float64 to rtol 1e-12; float32 to rtol 1e-6 (XLA and torch float32
    log differ by an ulp, which moves a corner weight by ~1e-7), both with
    an absolute floor at that fraction of the largest displacement, for
    curve values that cross zero."""
    jdt, tdt = ((jnp.float64, torch.float64) if dt == "f64"
                else (jnp.float32, torch.float32))
    M, a = _halos()
    jm, tm = jax_model(), torch_model()
    if dt == "f32":
        jm = jm.with_dtype(jdt)
    tm = tm.with_dtype(tdt)
    jc, jr0, jdl = jax.jit(lambda M, a: jm.halo_curves(M, a))(M, a)
    tc, tr0, tdl = tm.halo_curves(M, a)
    assert tc.dtype == tdt and tc.shape == (M.size, 64)
    jc = np.asarray(jc)
    rtol = 1e-12 if dt == "f64" else 1e-6
    np.testing.assert_allclose(tc.numpy(), jc, rtol=rtol,
                               atol=rtol * np.abs(jc).max())
    assert float(tr0) == float(jr0) and float(tdl) == float(jdl)
    assert not tc[:4].any() and tc[4:].abs().max() > 0


def test_multilinear_readout_matches_jax():
    """The full (z, M, r) readout, float64."""
    rng = np.random.default_rng(12)
    r = np.geomspace(1e-3, 60, 40)
    jm, tm = jax_model(), torch_model()
    for M, a in [(10 ** rng.uniform(13, 14.8, 7), 0.52), (3e14, 0.55)]:
        j = np.asarray(jm.displacement(r, M, a))
        t = tm.displacement(r, M, a).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-12,
                                   atol=1e-12 * np.abs(j).max())


def test_curve_lookup_matches_jax():
    jm = jax_model()
    M, a = _halos(n=50, seed=13)
    c, r0, dl = jm.halo_curves(M, a)
    c = np.asarray(c)
    rng = np.random.default_rng(14)
    r = np.exp(rng.uniform(-8, 5, (50, 30)))
    j = np.asarray(jax.vmap(lambda cc, rr: jm.curve_lookup(
        cc, float(r0), float(dl), rr))(jnp.asarray(c), jnp.asarray(r)))
    t = Baryonification2D.curve_lookup(torch.tensor(c), float(r0),
                                       float(dl), torch.as_tensor(r))
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-12,
                               atol=1e-12 * np.abs(j).max())


def _same_model(a, b):
    assert type(a) is type(b)
    assert a.p_keys == b.p_keys and a.Rdelta_sampling == b.Rdelta_sampling
    assert a.epsilon_max == b.epsilon_max and a.mass_def == b.mass_def
    assert a.cosmo == b.cosmo
    for k in ("d", "z_range", "M_range", "r_range"):
        x, y = getattr(a, f"raw_input_{k}"), getattr(b, f"raw_input_{k}")
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a._axes + (a._table,), b._axes + (b._table,)):
        assert x.dtype == y.dtype == torch.float64
        assert torch.equal(x, y)


def test_convert_matches_load_table(tmp_path):
    """baryonification_from_jax on a JAX model that loaded the npz gives
    the same port object as load_table on the npz; a save/load round trip
    keeps it."""
    ported = convert.baryonification_from_jax(jax_model())
    loaded = torch_model()
    _same_model(ported, loaded)
    path = tmp_path / "table.npz"
    loaded.save_table(path)
    _same_model(torch_model().load_table(path), loaded)


def test_cosmology_from_jax():
    j = jcosmo.cosmology_from_dict(COSMO_DICT)
    t = convert.cosmology_from_jax(j)
    assert t == tcore.cosmology_from_dict(COSMO_DICT)
    a = np.linspace(0.3, 1.0, 50)
    np.testing.assert_allclose(
        tcore.angular_diameter_distance(t, a).numpy(),
        np.asarray(jcosmo.angular_diameter_distance(j, a)), rtol=1e-12)
    for md in ("MassDef200c", "MassDef200m", "MassDef500c"):
        from baryonforge_tpu.cosmo import massdef as jmd
        from baryonforge_torch.cosmo import massdef as tmd
        M = np.geomspace(1e12, 1e15, 20)
        np.testing.assert_allclose(
            getattr(tmd, md).get_radius(t, M, a[:20]).numpy(),
            np.asarray(getattr(jmd, md).get_radius(j, M, a[:20])),
            rtol=1e-12)


def p_key_table(n_p, seed=15):
    """A random (z, M, r, p1[, p2]) table with its axis grids and halos:
    increasing but unevenly spaced axes, raw (not log) parameter values,
    and halos inside the table plus rows off each axis."""
    rng = np.random.default_rng(seed)
    shape = (5, 7, 16) + (4, 3)[:n_p]
    axes = [np.cumsum(rng.uniform(0.2, 1.0, n)) for n in shape]
    table = rng.normal(size=shape)
    n = 200
    M = np.exp(rng.uniform(axes[1][0], axes[1][-1], n))
    a = 1.0 / np.exp(rng.uniform(axes[0][0], axes[0][-1], n))
    p = {f"p{k}": rng.uniform(axes[3 + k][0], axes[3 + k][-1], n)
         for k in range(n_p)}
    M[0] = np.exp(axes[1][-1]) * 1.5
    a[1] = 1.0 / np.exp(axes[0][0] * 0.5)
    for k in range(n_p):
        p[f"p{k}"][2 + k] = axes[3 + k][-1] + 1.0
        p[f"p{k}"][4] = axes[3 + k][0]          # on the first grid point
    return table, axes, M, a, p


@pytest.mark.parametrize("n_p", [1, 2])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_collapse_curves_p_keys_match_jax(n_p, dt):
    """K1's plain version on tables with parameter axes against the JAX
    collapse_curves: float64 to rtol 1e-12, float32 to rtol 1e-6 (with an
    absolute floor at that fraction of the largest value); rows with a
    coordinate off any axis come back as fill."""
    table, axes, M, a, p = p_key_table(n_p)
    jdt, tdt = ((jnp.float64, torch.float64) if dt == "f64"
                else (jnp.float32, torch.float32))
    keys = sorted(p)
    jc, jr0, jdl = jax.jit(lambda t, ax, M, a, p: jinterp.collapse_curves(
        t, ax, 2, M, a, keys, p, fill=-3.0))(
        jnp.asarray(table, jdt), tuple(jnp.asarray(x, jdt) for x in axes),
        M, a, p)
    _build.reset_launches()
    tc, tr0, tdl = tinterp.collapse_curves(
        torch.as_tensor(table, dtype=tdt),
        tuple(torch.as_tensor(x, dtype=tdt) for x in axes), 2, M, a, keys, p,
        fill=-3.0)
    assert not _build.launches          # CPU tensors: the plain version
    jc = np.asarray(jc)
    rtol = 1e-12 if dt == "f64" else 1e-6
    assert tc.dtype == tdt and tc.shape == jc.shape == (M.size, 16)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=rtol,
                               atol=rtol * np.abs(jc).max())
    assert float(tr0) == float(jr0) and float(tdl) == float(jdl)
    off = [0, 1] + [2 + k for k in range(n_p)]
    assert (tc[off] == -3.0).all() and (tc[5:] != -3.0).all()


def test_p_key_model_crosses_over(tmp_path):
    """A JAX model whose table has a parameter axis converts with its
    table, axes and p_keys intact, and its halo curves (K1's plain
    version) match the JAX model's, float64 to rtol 1e-12."""
    with np.load(TABLE, allow_pickle=True) as f:
        d = f["d"]
        ranges = {k: f[k] for k in ("z_range", "M_range", "r_range")}
    c_grid = np.array([2.0, 4.0, 7.0])
    d_p = d[..., None] * (1.0 + 0.1 * c_grid)
    path = tmp_path / "pkey_table.npz"
    np.savez(path, d=d_p, p_keys=np.array(["conc"], dtype=object),
             p_conc=c_grid, Rdelta_sampling=np.array(False),
             allow_pickle=True, **ranges)
    jm = jax_model().load_table(str(path))
    ported = convert.baryonification_from_jax(jm)
    _same_model(ported, torch_model().load_table(path))
    assert ported.p_keys == ["conc"]
    np.testing.assert_array_equal(ported.raw_input_conc_range, c_grid)
    M, a = _halos(n=100, seed=16)
    conc = np.random.default_rng(17).uniform(1.5, 7.5, M.size)
    jc = np.asarray(jm.halo_curves(M, a, conc=conc)[0])
    tc = ported.halo_curves(M, a, conc=conc)[0].numpy()
    np.testing.assert_allclose(tc, jc, rtol=1e-12,
                               atol=1e-12 * np.abs(jc).max())
    assert not tc[:4].any() and not tc[conc < 2.0].any()
    assert np.abs(tc[4:][conc[4:] >= 2.0]).max() > 0


def test_collapse_curves_rejects_bad_tables():
    table, axes, M, a, p = p_key_table(2)
    t = torch.as_tensor(table)
    ax = tuple(torch.as_tensor(x) for x in axes)
    with pytest.raises(ValueError, match="p9"):
        tinterp.collapse_curves_plain(t, ax, 2, M, a, ["p0", "p9"], p)
