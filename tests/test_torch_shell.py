"""The whole torch BaryonifyShell (plain versions on the CPU) against the
JAX runner's BaryonifyShell.process(), on the bench-like catalog at small
sizes: the scatter path (deposit="scatter", regrid="scatter") and the
default tiled engine (tile deposit, stencil regrid and its complement)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Runners as JRunners             # noqa: E402
from baryonforge_tpu.cosmo.core import cosmology_from_dict  # noqa: E402
from baryonforge_torch import BaryonifyShell                # noqa: E402
from baryonforge_torch import clear_geometry_cache          # noqa: E402
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
# the spans and counters in runner.timings (utils.trace) of every curve
# path, and of the tiled engine's
SPANS = ["host_prep.cosmology", "host_prep.columns", "host_prep.map_upload",
         "host_prep.empty_check", "download.wait", "download.convert",
         "copy.h2d", "copy.d2h", "process.check", "count.h2d_bytes",
         "count.d2h_bytes"]
TILED_SPANS = ["binning.pack", "binning.tiling", "binning.bin",
               "binning.refine", "binning.csr", "cache.tiling", "cache.crad",
               "cache.stencil_tables", "cache.stencil_geo",
               "regrid.hot_tiles", "count.pairs", "count.pairs_kept",
               "count.cache_fills", "count.cache_hits"]


@pytest.fixture(autouse=True)
def _fresh_geometry_cache():
    """Each test starts and ends with the port's process-wide geometry
    cache empty (ops.geometry), so that a fresh runner's fills do not
    depend on which tests ran before it in the same worker."""
    clear_geometry_cache()
    yield
    clear_geometry_cache()


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
    assert {k for k in runner.timings if "." not in k} == {
        "host_prep", "curves", "deposit", "regrid", "download"}
    assert set(SPANS) <= set(runner.timings)


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
    """"auto" is the tiled engine, the JAX package's default: the same map
    as deposit="tiles", regrid="stencil". A zero map passes through."""
    cat, shell = make_inputs(32, 20)
    tcat, tshell = _torch_inputs(cat, shell)
    kw = dict(epsilon_max=20, model=torch_model(), device="cpu")
    np.testing.assert_array_equal(
        BaryonifyShell(tcat, tshell, **kw).process(),
        BaryonifyShell(tcat, tshell, deposit="tiles", regrid="stencil",
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
    with pytest.raises(TypeError, match="mesh"):
        BaryonifyShell(tcat, tshell, device="cpu", mesh=object(), **kw)
    for bad in (dict(deposit="stencil"), dict(regrid="tiles")):
        with pytest.raises(ValueError, match="expected one of"):
            BaryonifyShell(tcat, tshell, device="cpu", **bad, **kw)


def test_mass_loss_raises(monkeypatch):
    """The conservation check is a raise, not an assert (it survives -O),
    on the scatter path and on the tiled engine."""
    cat, shell = make_inputs(32, 20)
    tcat, tshell = _torch_inputs(cat, shell)
    monkeypatch.setattr(THR, "_regrid",
                        lambda nside, po, orig: orig * 0.5)
    monkeypatch.setattr(THR._stencil, "stencil_complement",
                        lambda tiling, out, *a: out * 0.5)
    for kw in (dict(deposit="scatter"), {}):
        with pytest.raises(RuntimeError, match="sum"):
            BaryonifyShell(tcat, tshell, epsilon_max=20, model=torch_model(),
                           device="cpu", **kw).process()


# ---- the default tiled engine ---------------------------------------------
def _jax_default_out(cat, shell, dt, rdt):
    """The JAX runner's default map (tile deposit, stencil regrid). Its
    small-disc halos go through the scatter body with one radius bucket,
    and the assert keeps the reference clear of the compile-cache fault of
    ``_jax_out``."""
    jr = JRunners.BaryonifyShell(
        cat, shell, epsilon_max=20, model=jax_model(), dtype=JDT[dt],
        regrid_dtype=JDT[rdt], n_size_buckets=1, verbose=False)
    jr._refresh_tokens()
    hd = jr._host_halo_data(cosmology_from_dict(jr.cosmo))
    small = jr._small_disc_mask(hd, shell.NSIDE)
    groups = jr._prepare_groups({k: v[small] for k, v in hd.items()}, [],
                                shell.NSIDE)
    shapes = [b[0].shape for _, _, b in groups]
    assert len(set(shapes)) == len(shapes), shapes
    return jr.process(), small


@pytest.fixture(scope="module", params=[(64, 150), (256, 300)],
                ids=["nside64", "nside256"])
def default_case(request):
    nside, n_halos = request.param
    cat, shell = _inputs(nside, n_halos)
    ref = {}
    for dt in ("f64", "f32"):
        ref[dt], small = _jax_default_out(cat, shell, dt, dt)
    return nside, cat, shell, ref, small


def _run_default(cat, shell, dt):
    tcat, tshell = _torch_inputs(cat, shell)
    runner = BaryonifyShell(tcat, tshell, epsilon_max=20,
                            model=torch_model(), dtype=TDT[dt],
                            regrid_dtype=TDT[dt], device="cpu")
    return runner.process(), runner


def test_default_shell_f64_matches_jax(default_case):
    """float64 deposit and regrid, the tiled engine against the JAX
    default: sum to rtol 1e-10, map to atol 1e-9 of the largest pixel
    change. Small discs take K2's plain version (at NSIDE 64 every disc of
    this catalog is small); at NSIDE 256 some 40% take the tiles (K4's)."""
    nside, cat, shell, ref, small = default_case
    out_t, runner = _run_default(cat, shell, "f64")
    orig = np.asarray(shell.map)
    assert small.any() and (nside < 256 or small.mean() < 0.7)
    np.testing.assert_allclose(out_t.sum(), orig.sum(), rtol=1e-10)
    scale = np.abs(ref["f64"] - orig).max()
    assert scale > 0
    np.testing.assert_allclose(out_t, ref["f64"], rtol=0, atol=1e-9 * scale)
    assert {k for k in runner.timings if "." not in k} == {
        "host_prep", "curves", "binning", "deposit", "regrid", "download"}
    assert set(SPANS + TILED_SPANS) <= set(runner.timings)
    assert runner.timings["count.pairs_kept"] <= runner.timings[
        "count.pairs"]


def test_default_shell_bench_dtypes_match_jax(default_case):
    """float32 deposit and regrid (the bench's dtypes), held as
    test_shell_bench_dtypes_match_jax holds the scatter path: the
    per-pixel edge-jitter bound against the JAX float32 map, and the
    port's error against the JAX float64 map at most 1.25 times the JAX
    float32 error (per pixel, or the float32 weight noise where that is
    larger, and summed). The summed edge-jitter bound is left out: the
    float32 regrid's rounding (~1e-7 of each pixel) summed over every
    pixel exceeds it in either package."""
    nside, cat, shell, ref, _ = default_case
    out_t, _ = _run_default(cat, shell, "f32")
    orig = np.asarray(shell.map)
    out_j, out_64 = ref["f32"], ref["f64"]
    assert np.isfinite(out_t).all()
    np.testing.assert_allclose(out_t.sum(), orig.sum(), rtol=1e-5)
    scale = np.abs(out_64 - orig).max()
    np.testing.assert_allclose(out_t, out_j, atol=0.02 * scale)
    err_t, err_j = np.abs(out_t - out_64), np.abs(out_j - out_64)
    assert err_t.max() <= max(1.25 * err_j.max(), 1e-6 * nside * orig.max())
    assert err_t.sum() <= 1.25 * err_j.sum()


def test_stencil_needs_tiles(monkeypatch):
    """As in the JAX runner, regrid="stencil" with deposit="scatter" takes
    the scatter regrid; deposit="tiles" with regrid="scatter" runs the
    tiled phase A, its flat view and the scatter regrid, which give the
    stencil's map in float64."""
    cat, shell = _inputs(64, 60)
    tcat, tshell = _torch_inputs(cat, shell)
    kw = dict(epsilon_max=20, model=torch_model(), dtype=torch.float64,
              regrid_dtype=torch.float64, device="cpu")
    calls = []
    real = THR.BaryonifyShell._regrid_stencil

    def spy(self, *a):
        calls.append(a[0])
        return real(self, *a)

    monkeypatch.setattr(THR.BaryonifyShell, "_regrid_stencil", spy)
    out_ss = BaryonifyShell(tcat, tshell, deposit="scatter",
                            regrid="stencil", **kw).process()
    assert not calls
    np.testing.assert_array_equal(
        out_ss, BaryonifyShell(tcat, tshell, deposit="scatter",
                               regrid="scatter", **kw).process())
    out_ts = BaryonifyShell(tcat, tshell, deposit="tiles", regrid="scatter",
                            **kw).process()
    assert not calls
    out_auto = BaryonifyShell(tcat, tshell, **kw).process()
    assert calls == [64]
    orig = np.asarray(shell.map)
    scale = np.abs(out_auto - orig).max()
    np.testing.assert_allclose(out_ts, out_auto, rtol=0, atol=1e-9 * scale)
