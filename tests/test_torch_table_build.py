"""The Schneider19 displacement-table build of the torch port against
baryonforge_tpu's: the enclosed-mass curves and displacement rows (plain
versions of kernel K9 on the CPU), setup_interpolator (plain, with a
parameter axis, with R_Delta sampling, and at the bench's size), and a
shell baryonified from the port's table against the JAX shell from the JAX
table.

Both packages build from the bench's profile parameters (bench.py:42-55)
on the CPU. Tolerance: 1e-9 of the largest |d| (the builds agree to
~1e-11 of it, measured: ulp-level differences of the profile physics
through the PCHIP inversion). The masks of the running-maximum (1e-5) and
DMO != DMB (1e-6) tests must agree exactly: a row that flips is named in
the message.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Profiles as JP                  # noqa: E402
from baryonforge_tpu import Runners as JRunners             # noqa: E402
from baryonforge_tpu import cosmo as jc                     # noqa: E402
from baryonforge_tpu.cosmo.core import cosmology_from_dict  # noqa: E402
from baryonforge_tpu.Profiles import BaryonCorrection as JBC  # noqa: E402
from baryonforge_tpu.ops.integrate import \
    cumulative_simpson_uniform as jcumsimpson               # noqa: E402
from baryonforge_tpu.ops.interp import \
    masked_pchip_interp as jmasked_pchip                    # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch import Profiles as TP                # noqa: E402
from baryonforge_torch.ops import _build, table_rows       # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from test_torch_cuda import rows_inputs                     # noqa: E402
from test_torch_curves import BPAR, COSMO_DICT, TABLE       # noqa: E402
from test_torch_integrate_interp import close               # noqa: E402
from test_torch_shell import _inputs, _torch_inputs         # noqa: E402

SMALL = dict(z_min=0.7, z_max=1.1, N_samples_z=2, M_min=5e12, M_max=2e15,
             N_samples_Mass=4, R_min=1e-3, R_max=60, N_samples_R=16,
             verbose=False)
BENCH = dict(SMALL, N_samples_z=8, N_samples_Mass=20, N_samples_R=64)
TOL = 1e-9


def models(cls2d=True, **prof_kw):
    """(JAX model, port model on the CPU) with the bench's profiles."""
    kw = dict(BPAR, proj_cutoff=100, **prof_kw)
    jcls = JBC.Baryonification2D if cls2d else JBC.Baryonification3D
    tcls = TP.Baryonification2D if cls2d else TP.Baryonification3D
    jm = jcls(JP.DarkMatterOnly(**kw), JP.DarkMatterBaryon(**kw),
              jc.cosmology_from_dict(COSMO_DICT), epsilon_max=20)
    tm = tcls(TP.DarkMatterOnly(**kw), TP.DarkMatterBaryon(**kw),
              bf.cosmo.cosmology_from_dict(COSMO_DICT), epsilon_max=20,
              device="cpu")
    return jm, tm


def assert_tables_close(jm, tm):
    dj, dt = jm.raw_input_d, tm.raw_input_d
    assert dt.shape == dj.shape and dt.dtype == np.float64
    scale = np.abs(dj).max()
    assert scale > 0
    err = np.abs(dt - dj)
    worst = np.unravel_index(err.argmax(), err.shape)
    assert err.max() <= TOL * scale, (
        f"table off by {err.max():.3e} (max |d| {scale:.3e}) at (z, M, r"
        f"...) = {worst}; a row whose 1e-5 / 1e-6 mask flipped shows here")
    for k in ("z_range", "M_range", "r_range"):
        np.testing.assert_array_equal(getattr(tm, f"raw_input_{k}"),
                                      getattr(jm, f"raw_input_{k}"))
    assert tm.p_keys == list(jm.p_keys)
    assert tm.Rdelta_sampling == jm.Rdelta_sampling
    for x, y in zip(tm._axes, jm._axes):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("projected", [True, False])
def test_enclosed_mass_curve_matches_jax(projected):
    jm, tm = models(cls2d=projected)
    r = np.geomspace(1e-3, 60, 24)
    Ms = np.geomspace(5e12, 2e15, 5)
    a = 1 / 1.9
    for jp, tp in ((jm.DMO, tm.DMO), (jm.DMB, tm.DMB)):
        _build.reset_launches()
        t = tm.get_masses(tp, r, Ms, a)
        assert not _build.launches
        close(t, jax_masses(jm, jp, r, Ms, a), 1e-10)


def jax_masses(jm, prof, r, Ms, a):
    """The JAX model's enclosed masses, jitted in a as its table build
    runs them (eager evaluation takes far longer)."""
    return np.asarray(jax.jit(lambda a: jm._enclosed_mass_curve(
        prof, r, Ms, a, projected=jm._projected))(a))


def _jax_masses():
    jm, _ = models()
    r = np.geomspace(1e-3, 60, 64)
    Ms = np.geomspace(5e12, 2e15, 20)
    a = 1 / 1.7
    return (np.log(r), jax_masses(jm, jm.DMO, r, Ms, a),
            jax_masses(jm, jm.DMB, r, Ms, a))


def test_displacement_rows_matches_jax():
    """On the JAX package's own masses, and on the same masses broken:
    NaN points, a non-increasing stretch, DMB == DMO stretches, a row with
    too few usable points and a row that is all NaN."""
    lnr, Mo, Mb = _jax_masses()
    Mo2, Mb2 = Mo.copy(), Mb.copy()
    Mb2[1, 10:14] = np.nan
    Mo2[2, 30:33] = Mo2[2, 29]                 # flat: fails the 1e-5 test
    Mb2[3, 40:50] = Mo2[3, 40:50]              # equal: fails the 1e-6 test
    Mb2[4, 20:25] = Mb2[4, 19] * 0.999         # decreasing
    Mb2[5, 5:] = np.nan                        # 5 usable points: broken row
    Mo2[6, :] = np.nan
    Mb2[7, 0] = np.nan                         # the forced first DMB point
    for o, b in ((Mo, Mb), (Mo2, Mb2)):
        j = np.asarray(JBC._displacement_rows(jnp.asarray(lnr),
                                              jnp.asarray(o), jnp.asarray(b)))
        t = table_rows.displacement_rows(torch.as_tensor(lnr),
                                         torch.as_tensor(o),
                                         torch.as_tensor(b))
        flips = np.where((np.isnan(t.numpy()) != np.isnan(j)).any(1))[0]
        assert not flips.size, f"rows whose masks flipped: {flips}"
        close(t, j, 1e-10)
    assert np.isnan(t.numpy()[5]).all() and np.isnan(t.numpy()[6]).all()


def jax_enclosed_tail(intgd, dens, lnr_int, lnr_out):
    """The JAX _enclosed_mass_curve after its profile evaluation
    (baryonforge_tpu/Profiles/BaryonCorrection.py:88-100) on given rows."""
    intgd, dens = jnp.asarray(intgd), jnp.asarray(dens)
    M_enc = jcumsimpson(intgd, dx=1.0, axis=-1) + intgd[:, :1]
    valid = (dens > 0) & jnp.isfinite(M_enc) & (M_enc > 0)

    def row(mrow, vrow):
        return jnp.exp(jmasked_pchip(
            jnp.asarray(lnr_int), jnp.log(jnp.where(vrow, mrow, 1.0)), vrow,
            jnp.asarray(lnr_out), min_pts=2))
    return np.asarray(jax.jit(jax.vmap(row))(M_enc, valid))


def test_displacement_table_matches_jax():
    """K9's fused rows (``displacement_table``, its plain version on the
    CPU) against the JAX enclosed-mass tail (twice) and
    ``_displacement_rows`` on the same rows: 6 masses, 200 grid points
    (not a multiple of 32), 24 radii, with a broken row (at most 5 usable
    points), a DMO mass that stops being finite and an all-NaN row; NaN
    masks identical."""
    io, do, ib, db, lnr_int, lnr = rows_inputs(6, 200, 24)
    t_in = [torch.as_tensor(x) for x in (io, do, ib, db, lnr_int, lnr)]
    Mo = jax_enclosed_tail(io, do, lnr_int, lnr)
    Mb = jax_enclosed_tail(ib, db, lnr_int, lnr)
    for t, j in ((table_rows.enclosed_mass(*t_in[:2], *t_in[4:]), Mo),
                 (table_rows.enclosed_mass(*t_in[2:]), Mb)):
        close(t, j, 1e-12)
    j = np.asarray(jax.jit(JBC._displacement_rows)(
        jnp.asarray(lnr), jnp.asarray(Mo), jnp.asarray(Mb)))
    _build.reset_launches()
    t = table_rows.displacement_table(*t_in)
    assert not _build.launches
    flips = np.where((np.isnan(t.numpy()) != np.isnan(j)).any(1))[0]
    assert not flips.size, f"rows whose masks flipped: {flips}"
    close(t, j, 1e-10)
    d = t.numpy()
    assert (np.isfinite(d[[0, 4, 5]]).sum(1) > d.shape[1] // 2).all()
    assert np.isnan(d[1]).all() and np.isnan(d[3]).all()
    assert np.isnan(d[2]).any() and not np.isnan(d[2]).all()


@pytest.mark.parametrize("variant", ["plain", "p_keys", "rdelta"])
def test_setup_interpolator_matches_jax(variant):
    kw = dict(SMALL)
    if variant == "p_keys":
        kw["other_params"] = {"theta_ej": [3, 5]}
    elif variant == "rdelta":
        kw["Rdelta_sampling"] = True
    jm, tm = models()
    jm.setup_interpolator(**kw)
    assert tm.setup_interpolator(**kw) is tm
    assert_tables_close(jm, tm)
    if variant == "p_keys":
        assert tm.p_keys == ["theta_ej"] and tm._table.shape == (2, 4, 16, 2)
        np.testing.assert_array_equal(tm.raw_input_theta_ej_range, [3, 5])
        # the profiles keep the last value, as in the JAX package
        assert tm.DMB.Gas.theta_ej == jm.DMB.Gas.theta_ej == 5


def test_setup_interpolator_of_converted_model():
    """baryonification_from_jax carries the JAX model's profiles; the port
    builds the same table from them."""
    jm, _ = models()
    tm = convert.baryonification_from_jax(jm, device="cpu")
    assert type(tm.DMB) is TP.DarkMatterBaryon
    assert not hasattr(tm, "_table")
    jm.setup_interpolator(**SMALL)
    tm.setup_interpolator(**SMALL)
    assert_tables_close(jm, tm)


@pytest.fixture(scope="module")
def bench_tables():
    """The bench's table (8 z x 20 M x 64 r) from both packages."""
    jm, tm = models()
    jm.setup_interpolator(**BENCH)
    tm.setup_interpolator(**BENCH)
    return jm, tm


def test_bench_table_matches_jax(bench_tables):
    """The exact check that the card cannot run: the whole bench table,
    port against JAX. Both sit 2e-5 (1.2e-4 of max |d|) from
    tools/_northstar_table.npz, which predates later JAX profile changes."""
    jm, tm = bench_tables
    assert_tables_close(jm, tm)
    with np.load(TABLE) as f:
        old = f["d"]
    drift = np.abs(tm.raw_input_d - old).max() / np.abs(old).max()
    assert drift < 2.5e-4


def test_shell_from_port_table_matches_jax(bench_tables):
    """NSIDE 64: the port's scatter path (float64, plain versions) from the
    port-built table against the JAX scatter path from the JAX-built table,
    to the shell parity bound (tests/test_tiled_deposit.py:80)."""
    jm, tm = bench_tables
    cat, shell = _inputs(64, 150)
    jr = JRunners.BaryonifyShell(
        cat, shell, epsilon_max=20, model=jm, deposit="scatter",
        regrid="scatter", dtype=jnp.float64, regrid_dtype=jnp.float64,
        n_size_buckets=1, verbose=False)
    jr._refresh_tokens()
    groups = jr._prepare_groups(
        jr._host_halo_data(cosmology_from_dict(jr.cosmo)), [], shell.NSIDE)
    shapes = [b[0].shape for _, _, b in groups]
    assert len(set(shapes)) == len(shapes), shapes
    out_j = jr.process()
    tcat, tshell = _torch_inputs(cat, shell)
    out_t = bf.BaryonifyShell(tcat, tshell, epsilon_max=20, model=tm,
                              deposit="scatter", regrid="scatter",
                              dtype=torch.float64,
                              regrid_dtype=torch.float64,
                              device="cpu").process()
    orig = np.asarray(shell.map)
    scale = np.abs(out_j - orig).max()
    assert scale > 0
    np.testing.assert_allclose(out_t.sum(), orig.sum(), rtol=1e-10)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-9 * scale)


def test_broken_rows_warn_and_zero(monkeypatch):
    """A row whose inversion fails everywhere is zeroed with a UserWarning
    naming its mass, as in the JAX package."""
    _, tm = models()
    real = table_rows.displacement_table

    def broken(*rows):
        d = real(*rows)
        d[1] = float("nan")
        return d
    monkeypatch.setattr(table_rows, "displacement_table", broken)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tm.setup_interpolator(**dict(SMALL, verbose=True))
    msgs = [str(x.message) for x in w if x.category is UserWarning]
    assert len(msgs) == SMALL["N_samples_z"]
    assert all("log10(M) = 13.57" in m for m in msgs), msgs
    assert not tm.raw_input_d[:, 1].any() and tm.raw_input_d[:, 0].any()


def test_table_build_needs_its_device_and_profiles():
    _, tm = models()
    cuda = TP.Baryonification2D(tm.DMO, tm.DMB, tm.cosmo)
    assert cuda.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cuda.setup_interpolator(**SMALL)
    no_prof = TP.Baryonification2D(None, None, tm.cosmo, device="cpu")
    with pytest.raises(ValueError, match="DMO and DMB"):
        no_prof.setup_interpolator(**SMALL)
    with pytest.raises(ValueError, match="z_linear_sampling"):
        tm.setup_interpolator(**dict(SMALL, z_min=0.0))
    with pytest.raises(ValueError, match="device"):
        TP.Baryonification2D(None, None, tm.cosmo, device="meta")
