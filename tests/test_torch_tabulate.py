"""Tabulated profiles of the torch port (utils/Tabulate.py, plain torch on
the CPU) against baryonforge_tpu.utils.Tabulate, on the same grids.

The JAX tSZ table, TabulatedProfile(ThermalSZ(Pressure(**bpar,
proj_cutoff=100), proj_cutoff=100)) at 2 z x 4 M x 32 r, is built once for
the module (its build is mostly compile time) and against it: the port's
log tables (1e-9 where finite, equal +-inf masks), the readout, the
per-halo curves (plain version of K1, fill -inf) and the curve lookups,
checkpoints in both directions and the conversion of the JAX object. A
ParamTabulatedProfile of the gas profile with one parameter axis does the
same for raw curves (fill 0).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Profiles as JProfiles           # noqa: E402
from baryonforge_tpu import utils as JUtils                 # noqa: E402
from baryonforge_tpu.cosmo import core as jcore             # noqa: E402
from baryonforge_tpu.Profiles.BaryonCorrection import \
    BaryonificationClass as JBC                             # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from test_torch_curves import BPAR, COSMO_DICT              # noqa: E402

GRID = dict(z_min=0.7, z_max=1.1, N_samples_z=2, M_min=5e12, M_max=2e15,
            N_samples_Mass=4, R_min=1e-3, R_max=60, N_samples_R=32,
            verbose=False)
P_GRID = dict(GRID, N_samples_R=16)
P_VALS = {"theta_ej": np.array([3.0, 5.0])}


def _tsz(P):
    T = P.Thermodynamic
    return T.ThermalSZ(T.Pressure(**BPAR, proj_cutoff=100), proj_cutoff=100)


@pytest.fixture(scope="module")
def tables():
    jc = jcore.cosmology_from_dict(COSMO_DICT)
    tc = bf.cosmo.cosmology_from_dict(COSMO_DICT)
    jt = JUtils.TabulatedProfile(_tsz(JProfiles), jc).setup_interpolator(
        **GRID)
    tt = bf.utils.TabulatedProfile(_tsz(bf.Profiles), tc, device="cpu")
    tt.setup_interpolator(**GRID)
    return jt, tt


@pytest.fixture(scope="module")
def param_tables():
    jc = jcore.cosmology_from_dict(COSMO_DICT)
    tc = bf.cosmo.cosmology_from_dict(COSMO_DICT)
    jt = JUtils.ParamTabulatedProfile(JProfiles.Gas(**BPAR), jc)
    jt.setup_interpolator(other_params=P_VALS, **P_GRID)
    tt = bf.utils.ParamTabulatedProfile(bf.Profiles.Gas(**BPAR), tc,
                                        device="cpu")
    tt.setup_interpolator(other_params=P_VALS, **P_GRID)
    return jt, tt


def _halos(n=40, seed=3):
    """Masses and scale factors inside the table, the first four off it
    (mass and redshift on both sides)."""
    rng = np.random.default_rng(seed)
    M = 10 ** rng.uniform(np.log10(6e12), np.log10(1.9e15), n)
    a = 1.0 / (1.0 + rng.uniform(0.72, 1.08, n))
    M[0], M[1] = 1e12, 5e15
    a[2], a[3] = 1.0 / 1.5, 1.0 / 1.05 + 0.2
    return M, a


def test_log_tables_match_jax(tables):
    """log(real) and log(projected * a): 1e-9 where finite (the profiles
    agree to ~3e-13, tests/test_torch_thermo.py), and equal +-inf
    masks."""
    jt, tt = tables
    for k in ("raw_input_3D", "raw_input_2D", "raw_input_z_range",
              "raw_input_M_range", "raw_input_r_range"):
        t, j = getattr(tt, k), getattr(jt, k)
        assert t.shape == j.shape, k
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j),
                                      err_msg=k)
        fin = np.isfinite(j)
        np.testing.assert_allclose(t[fin], j[fin], rtol=0, atol=1e-9,
                                   err_msg=k)
    assert np.isfinite(tt.raw_input_2D).mean() > 0.9


def test_readout_matches_jax(tables):
    """real and projected at radii and masses inside the table and past
    its edges (NaN there in both), rtol 1e-9."""
    jt, tt = tables
    r = np.geomspace(5e-4, 100.0, 13)
    M = np.array([3e12, 8e12, 3e14, 1.5e15])
    for a in (0.5, 0.52, 0.3):
        for m in ("real", "projected"):
            t = getattr(tt, m)(None, r, M, a).numpy()
            j = np.asarray(getattr(jt, m)(None, r, M, a))
            np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
            np.testing.assert_allclose(t, j, rtol=1e-9, err_msg=m)
    assert tt.projected(None, 0.1, 1e14, 0.52).dim() == 0


@pytest.mark.parametrize("kind", ["projected", "real"])
def test_halo_curves_match_jax(tables, kind):
    """The per-halo log curves in float64 and float32 (with_dtype), the
    rows off the table -inf, and the grid scalars; no kernel on the
    CPU."""
    jt, tt = tables
    M, a = _halos()
    _build.reset_launches()
    for dt, jdt, tol in ((torch.float64, jnp.float64, 1e-9),
                         (torch.float32, jnp.float32, 1e-4)):
        ct, r0t, dlt = tt.with_dtype(dt).halo_curves(M, a, kind=kind)
        cj, r0j, dlj = jt.with_dtype(jdt).halo_curves(M, a, kind=kind)
        ct, cj = ct.numpy(), np.asarray(cj)
        assert ct.dtype == np.dtype(jdt)
        np.testing.assert_array_equal(np.isneginf(ct), np.isneginf(cj))
        assert np.isneginf(ct[:4]).all() and np.isfinite(ct[4:]).all()
        np.testing.assert_allclose(ct[4:], cj[4:], rtol=0, atol=tol)
        assert float(r0t) == float(r0j) and float(dlt) == float(dlj)
    assert not _build.launches


def test_curve_lookups_match_jax(tables, param_tables):
    """TabulatedProfile.curve_lookup (exp of the lerp) and the raw lookup
    of ParamTabulatedProfile at radii across and past the grid (the JAX
    lookups take one halo's curve, so they are vmapped over halos)."""
    jt, tt = tables
    M, a = _halos()
    c, r0, dl = jt.halo_curves(M[4:], a[4:])
    c = np.array(c)
    r0, dl = float(r0), float(dl)
    r = np.geomspace(5e-4, 100.0, 29)[None, :].repeat(len(M) - 4, 0)
    _, tp = param_tables
    for t_lookup, j_lookup, curves in ((tt.curve_lookup, jt.curve_lookup, c),
                                       (tp.curve_lookup, JBC.curve_lookup,
                                        c / 30.0)):
        t = t_lookup(torch.as_tensor(curves), r0, dl,
                     torch.as_tensor(r)).numpy()
        j = np.asarray(jax.vmap(lambda cv, rr: j_lookup(cv, r0, dl, rr))(
            jnp.asarray(curves), jnp.asarray(r)))
        assert (t == 0).any() and (t != 0).any()
        np.testing.assert_allclose(t, j, rtol=1e-12, atol=0)


def test_param_tabulated_matches_jax(param_tables):
    """Raw tables with one parameter axis, readout with the parameter, and
    the per-halo raw curves (off-table rows 0)."""
    jt, tt = param_tables
    assert tt.p_keys == jt.p_keys == ["theta_ej"]
    assert tt.curves_are_log is False and jt.curves_are_log is False
    for t, j in ((tt._tab3D, jt._tab3D), (tt._tab2D, jt._tab2D)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-9)
    r = np.geomspace(2e-3, 30.0, 7)
    for m in ("real", "projected"):
        np.testing.assert_allclose(
            getattr(tt, m)(None, r, 1e14, 0.52, theta_ej=4.2).numpy(),
            np.asarray(getattr(jt, m)(None, r, 1e14, 0.52, theta_ej=4.2)),
            rtol=1e-9)
    M, a = _halos(12)
    p = np.linspace(3.1, 4.9, M.size)
    ct, _, _ = tt.halo_curves(M, a, theta_ej=p)
    cj, _, _ = jt.halo_curves(M, a, theta_ej=p)
    ct, cj = ct.numpy(), np.asarray(cj)
    assert (ct[:4] == 0).all() and (ct[4:] != 0).any()
    np.testing.assert_allclose(ct, cj, rtol=1e-9, atol=0)
    with pytest.raises(ValueError, match="theta_ej"):
        tt.projected(None, r, 1e14, 0.52)


def test_checkpoints_and_conversion(tables, param_tables, tmp_path):
    """save_table / load_table across the packages, and tabulated_from_jax
    for both classes: the same readout as the JAX object."""
    jt, tt = tables
    path = os.path.join(tmp_path, "t.npz")
    tt.save_table(path)
    jl = JUtils.TabulatedProfile(None, None, mass_def=jt.mass_def)
    jl.load_table(path)
    r = np.geomspace(2e-3, 30.0, 7)
    np.testing.assert_allclose(np.asarray(jl.projected(None, r, 1e14, 0.52)),
                               tt.projected(None, r, 1e14, 0.52).numpy(),
                               rtol=1e-12)
    jt.save_table(path)
    tl = bf.utils.TabulatedProfile(None, None, mass_def=tt.mass_def,
                                   device="cpu").load_table(path)
    np.testing.assert_array_equal(tl.raw_input_2D, jt.raw_input_2D)
    for j, t_cls in ((jt, bf.utils.TabulatedProfile),
                     (param_tables[0], bf.utils.ParamTabulatedProfile)):
        c = convert.tabulated_from_jax(j, device="cpu")
        assert type(c) is t_cls and c.model is not None
        assert c.p_keys == j.p_keys
        kw = {k: 4.0 for k in j.p_keys}
        np.testing.assert_allclose(
            c.projected(None, r, 1e14, 0.52, **kw).numpy(),
            np.asarray(j.projected(None, r, 1e14, 0.52, **kw)), rtol=1e-12)


def test_setup_needs_cuda_unless_cpu():
    """The build runs on CUDA by default and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tt = bf.utils.TabulatedProfile(bf.Profiles.Gas(**BPAR),
                                   bf.cosmo.cosmology_from_dict(COSMO_DICT))
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.setup_interpolator(**GRID)
    with pytest.raises(ValueError, match="ParamTabulatedProfile"):
        tt.setup_interpolator(other_params={"theta_ej": [1.0]})
