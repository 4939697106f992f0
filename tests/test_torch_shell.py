"""The whole torch BaryonifyShell (scatter path, plain versions on the CPU)
against the JAX runner's BaryonifyShell(deposit="scatter",
regrid="scatter").process(), on the bench-like catalog at small sizes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Runners as JRunners             # noqa: E402
from baryonforge_tpu.cosmo.core import cosmology_from_dict  # noqa: E402
from baryonforge_torch import BaryonifyShell                # noqa: E402
from baryonforge_torch import utils as tutils               # noqa: E402
from baryonforge_torch.cosmo import core as tcore           # noqa: E402
from baryonforge_torch.Runners import HealpixRunner as THR  # noqa: E402

from test_torch_curves import COSMO_DICT, jax_model, torch_model  # noqa
from test_torch_deposit import make_inputs                  # noqa: E402


def _torch_inputs(cat, shell):
    c = cat.cat
    return (tutils.HaloLightConeCatalog(ra=c["ra"], dec=c["dec"], M=c["M"],
                                        z=c["z"], cosmo=COSMO_DICT),
            tutils.LightconeShell(map=shell.map, cosmo=COSMO_DICT))


JDT = {"f32": jnp.float32, "f64": jnp.float64}
TDT = {"f32": torch.float32, "f64": torch.float64}


def _inputs(nside, n_halos):
    return make_inputs(nside, n_halos, seed=3, low_mass=True, n_cap=16)


def _jax_out(cat, shell, dt, rdt):
    """The JAX runner's map. It gets one radius bucket: its scatter path
    caches the compiled deposit by batch shape alone, so two size buckets
    with equal batch shapes would share one disc window (see
    test_torch_deposit.jax_phase_a). The near-cap halos of ``_inputs``
    make its two polar buckets differ in size; the assert keeps the
    reference clear of that fault."""
    jr = JRunners.BaryonifyShell(
        cat, shell, epsilon_max=20, model=jax_model(), deposit="scatter",
        regrid="scatter", dtype=JDT[dt], regrid_dtype=JDT[rdt],
        n_size_buckets=1, verbose=False)
    jr._refresh_tokens()
    groups = jr._prepare_groups(
        jr._host_halo_data(cosmology_from_dict(jr.cosmo)), [], shell.NSIDE)
    shapes = [b[0].shape for _, _, b in groups]
    assert len(set(shapes)) == len(shapes), shapes
    return jr.process()


def _run_both(nside, n_halos, dt, rdt):
    cat, shell = _inputs(nside, n_halos)
    out_j = _jax_out(cat, shell, dt, rdt)
    tcat, tshell = _torch_inputs(cat, shell)
    runner = BaryonifyShell(tcat, tshell, epsilon_max=20,
                            model=torch_model(), deposit="scatter",
                            regrid="scatter", dtype=TDT[dt],
                            regrid_dtype=TDT[rdt], device="cpu")
    out_t = runner.process()
    return np.asarray(shell.map), out_j, out_t, runner


@pytest.mark.parametrize("nside,n_halos", [(64, 150), (256, 300)])
def test_shell_f64_matches_jax(nside, n_halos):
    """float64 deposit and regrid: the sum is conserved to rtol 1e-10 and
    the map agrees to atol 1e-9 of the largest pixel change
    (tests/test_tiled_deposit.py:80)."""
    orig, out_j, out_t, _ = _run_both(nside, n_halos, "f64", "f64")
    assert out_t.dtype == np.float64 and out_t.shape == orig.shape
    np.testing.assert_allclose(out_t.sum(), orig.sum(), rtol=1e-10)
    scale = np.abs(out_j - orig).max()
    assert scale > 0, "displacement did nothing"
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-9 * scale)


def _jitter_bounds(orig, out_j, out_t):
    """The JAX package's edge-jitter bounds for a float32 deposit
    (tests/test_tiled_deposit.py:53-63): 0.02 of the largest pixel change
    per pixel, and 3e-3 of the moved mass summed over pixels."""
    scale = np.abs(out_j - orig).max()
    assert scale > 0
    np.testing.assert_allclose(out_t, out_j, atol=0.02 * scale)
    assert np.abs(out_t - out_j).sum() < 3e-3 * np.abs(out_j - orig).sum()


@pytest.mark.parametrize("nside,n_halos", [(64, 150), (256, 300)])
def test_shell_f32_deposit_matches_jax(nside, n_halos):
    """The JAX runner's defaults: float32 deposit, float64 regrid."""
    orig, out_j, out_t, _ = _run_both(nside, n_halos, "f32", "f64")
    np.testing.assert_allclose(out_t.sum(), orig.sum(), rtol=1e-10)
    _jitter_bounds(orig, out_j, out_t)


@pytest.mark.parametrize("nside,n_halos", [(64, 150), (256, 300)])
def test_shell_bench_dtypes_match_jax(nside, n_halos):
    """The bench's float32 deposit and float32 regrid. Float32 regrid
    weights carry ~1e-6 * nside of noise in either package (see
    test_torch_healpix), on every moved pixel, so the packages are held
    against the float64 map instead: the port's error summed over pixels
    at most 1.25 times the JAX float32 error, and per pixel at most that
    or the weight noise times the largest source value. Per pixel they also
    keep the edge-jitter bound of 0.02 of the largest pixel change, and
    mass is conserved to the reference's np.isclose rtol of 1e-5."""
    orig, out_j, out_t, runner = _run_both(nside, n_halos, "f32", "f32")
    out_64 = _jax_out(*_inputs(nside, n_halos), "f64", "f64")
    assert np.isfinite(out_t).all()
    np.testing.assert_allclose(out_t.sum(), orig.sum(), rtol=1e-5)
    scale = np.abs(out_64 - orig).max()
    np.testing.assert_allclose(out_t, out_j, atol=0.02 * scale)
    err_t, err_j = np.abs(out_t - out_64), np.abs(out_j - out_64)
    assert err_t.max() <= max(1.25 * err_j.max(), 1e-6 * nside * orig.max())
    assert err_t.sum() <= 1.25 * err_j.sum()
    assert set(runner.timings) == {"host_prep", "curves", "deposit",
                                   "regrid", "download"}


def test_host_prep_matches_jax():
    """R_Delta, D_A and the disc radii in float64, to rtol 1e-12."""
    cat, shell = make_inputs(64, 50)
    jr = JRunners.BaryonifyShell(cat, shell, epsilon_max=20,
                                 model=jax_model(), verbose=False)
    jhd = jr._host_halo_data(cosmology_from_dict(jr.cosmo))
    tcat, tshell = _torch_inputs(cat, shell)
    tr = BaryonifyShell(tcat, tshell, epsilon_max=20, model=torch_model(),
                        device="cpu")
    thd = tr._host_halo_data(tcore.cosmology_from_dict(tr.cosmo))
    for k in ("M", "z", "a", "R", "D", "theta", "phi", "radius"):
        np.testing.assert_allclose(thd[k], jhd[k], rtol=1e-12, err_msg=k)


def test_auto_is_scatter_and_zero_map_passes_through():
    cat, shell = make_inputs(32, 20)
    tcat, tshell = _torch_inputs(cat, shell)
    kw = dict(epsilon_max=20, model=torch_model(), device="cpu")
    np.testing.assert_array_equal(
        BaryonifyShell(tcat, tshell, **kw).process(),
        BaryonifyShell(tcat, tshell, deposit="scatter", regrid="scatter",
                       **kw).process())
    zero = tutils.LightconeShell(map=np.zeros(12 * 32 ** 2),
                                 cosmo=COSMO_DICT)
    assert not BaryonifyShell(tcat, zero, **kw).process().any()


def test_unsupported_configurations_raise():
    cat, shell = make_inputs(32, 10)
    tcat, tshell = _torch_inputs(cat, shell)
    kw = dict(epsilon_max=20, model=torch_model())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BaryonifyShell(tcat, tshell, **kw)
    for bad in (dict(deposit="tiles"), dict(regrid="stencil"),
                dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            BaryonifyShell(tcat, tshell, device="cpu", **bad, **kw)


def test_mass_loss_raises(monkeypatch):
    """The conservation check is a raise, not an assert (it survives -O)."""
    cat, shell = make_inputs(32, 20)
    tcat, tshell = _torch_inputs(cat, shell)
    monkeypatch.setattr(THR, "_regrid",
                        lambda nside, po, orig: orig * 0.5)
    with pytest.raises(RuntimeError, match="sum"):
        BaryonifyShell(tcat, tshell, epsilon_max=20, model=torch_model(),
                       device="cpu").process()
