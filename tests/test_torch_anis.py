"""The anisotropic shell paint of the torch port (plain versions of kernels
K12, K13 and K14 on the CPU, and PaintProfilesAnisShell with
device="cpu") against baryonforge_tpu.

The model, tracer and Mtot are the TabulatedProfile(DarkMatter(**bpar_S19,
proj_cutoff=100)) of tests/test_runners_extra.py:19-32, carried across
with utils.convert, on its shell (NSIDE 64, redshift 0.25, halos at z 0.1
to 0.4, epsilon_max 20: ~30 pixels a disc); its raw form (exp of the
tables, a ParamTabulatedProfile without parameter axes) runs the raw-curve
branches. Tolerances:
  * float64: 1e-10 of the map's largest value (the packages sum in other
    orders);
  * float32: the JAX package's own bound between its float32 tiled and
    scatter anisotropic paints (tests/test_runners_extra.py:250-261: rtol
    2e-2, atol 2e-5 of the largest value).
The JAX scatter runner runs with one radius bucket and distinct batch
shapes per colatitude class: it caches its compiled body on the batch
shapes and map tokens, not on the disc window (ROADMAP Queue 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Runners as JRunners             # noqa: E402
from baryonforge_tpu import utils as JUtils                 # noqa: E402
from baryonforge_tpu.cosmo import core as jcore             # noqa: E402
from baryonforge_tpu.ops import tiles as jt                 # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import paint                     # noqa: E402
from baryonforge_torch.ops import tiles as tt               # noqa: E402
from baryonforge_torch.ops import tile_deposit as td        # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from defaults import COSMO_DICT                             # noqa: E402
from test_runners_extra import _tab                         # noqa: E402

NSIDE = 64
JDT = {"f32": jnp.float32, "f64": jnp.float64}
TDT = {"f32": torch.float32, "f64": torch.float64}
KW = dict(epsilon_max=20, background_val=1.0, global_tracer_fraction=0.1)


def _raw(jtab):
    """The raw form of a JAX log table."""
    raw = JUtils.ParamTabulatedProfile(jtab.model, jtab.cosmo,
                                       mass_def=jtab.mass_def)
    raw._axes = jtab._axes
    raw._tab3D = jnp.exp(jtab._tab3D)
    raw._tab2D = jnp.exp(jtab._tab2D)
    raw.raw_input_r_range = jtab.raw_input_r_range
    return raw


@pytest.fixture(scope="module")
def models():
    """(JAX, port) pairs of the log table and its raw form."""
    jlog = _tab()
    jraw = _raw(jlog)
    return {k: (j, convert.tabulated_from_jax(j, device="cpu"))
            for k, j in (("log", jlog), ("raw", jraw))}


def catalog(n=24, seed=66):
    rng = np.random.default_rng(seed)
    return dict(ra=rng.uniform(0, 360, n),
                dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
                M=10 ** rng.uniform(13.5, 14.8, n),
                z=rng.uniform(0.1, 0.4, n)), rng.exponential(1.0,
                                                             12 * NSIDE ** 2)


def _shells(cols, m):
    return ((JUtils.HaloLightConeCatalog(**cols, cosmo=COSMO_DICT),
             JUtils.LightconeShell(map=m, cosmo=COSMO_DICT, redshift=0.25)),
            (bf.utils.HaloLightConeCatalog(**cols, cosmo=COSMO_DICT),
             bf.utils.LightconeShell(map=m, cosmo=COSMO_DICT,
                                     redshift=0.25)))


def jax_anis(jm, jt_, cols, m, deposit, dt, **kw):
    """The JAX runner's map (model jm, tracer and Mtot jt_)."""
    (cat, shell), _ = _shells(cols, m)
    jr = JRunners.PaintProfilesAnisShell(
        cat, shell, model=jm, Tracer_model=jt_, Mtot_model=jt_,
        deposit=deposit, dtype=JDT[dt], n_size_buckets=1, verbose=False,
        **dict(KW, **kw))
    if deposit == "scatter":
        jr._refresh_tokens()
        hd = jr._host_halo_data(jcore.cosmology_from_dict(jr.cosmo))
        curves = np.zeros((hd["M"].size, 48))
        shapes = [b[0].shape for _, _, b in
                  jr._prepare_groups(hd, [curves, curves], NSIDE)]
        assert len(set(shapes)) == len(shapes), shapes
    return np.asarray(jr.process(), dtype=np.float64)


def torch_anis(tm, tt_, cols, m, deposit, dt, runner=False, **kw):
    _, (cat, shell) = _shells(cols, m)
    r = bf.PaintProfilesAnisShell(cat, shell, model=tm, Tracer_model=tt_,
                                  Mtot_model=tt_, deposit=deposit,
                                  dtype=TDT[dt], device="cpu",
                                  **dict(KW, **kw))
    out = r.process()
    return (out, r) if runner else out


def _close(out, ref, dt):
    scale = np.abs(ref).max()
    assert scale > 0
    if dt == "f64":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10 * scale)
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-5 * scale)


@pytest.mark.parametrize("deposit", ["auto", "scatter"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_anis_shell_matches_jax(models, deposit, dt):
    """The whole runner, tiled (K10 canvas, K12, K14) and scatter (K11
    canvas, K13, K14), against the JAX runner; the halo term dominates
    the map (background_val 0 leaves nearly its largest value)."""
    jm, tm = models["log"]
    cols, m = catalog()
    _build.reset_launches()
    out, r = torch_anis(tm, tm, cols, m, deposit, dt, runner=True)
    assert not _build.launches            # CPU: the plain versions
    assert out.dtype == np.float64 and out.shape == m.shape
    ref = jax_anis(jm, jm, cols, m, deposit, dt)
    _close(out, ref, dt)
    phases = ["host_prep", "canvas", "curves", "paint", "finish",
              "download"]
    if deposit != "scatter":
        phases.insert(3, "binning")
    assert [k for k in r.timings if "." not in k] == phases
    spans = {"host_prep.cosmology", "host_prep.columns",
             "host_prep.map_upload", "download.wait", "download.convert",
             "copy.h2d", "copy.d2h", "count.h2d_bytes", "count.d2h_bytes",
             "anis.background"}
    if deposit != "scatter":
        spans |= {"binning.pack", "binning.bin", "binning.refine",
                  "binning.csr", "count.pairs", "count.pairs_kept",
                  "canvas.binning.pack", "canvas.binning.bin",
                  "canvas.binning.refine", "canvas.binning.csr",
                  "count.canvas.pairs", "count.canvas.pairs_kept",
                  "count.pair_searches"}
    assert spans <= set(r.timings)
    assert r.timings.get("count.pair_searches", 0) == (
        0 if deposit == "scatter" else 2)
    halo = torch_anis(tm, tm, cols, m, deposit, dt, background_val=0.0)
    assert np.abs(halo).max() > 0.9 * np.abs(out).max()


@pytest.mark.parametrize("deposit", ["auto", "scatter"])
def test_anis_shell_raw_curves_match_jax(models, deposit):
    """Raw model curves with log tracer and Mtot curves (tiled: the log
    operand exp'd up front and a raw product in K12), float64."""
    jr_, tr_ = models["raw"]
    jl, tl = models["log"]
    cols, m = catalog()
    _close(torch_anis(tr_, tl, cols, m, deposit, "f64"),
           jax_anis(jr_, jl, cols, m, deposit, "f64"), "f64")


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_anis_tiled_matches_scatter(models, dt):
    """The port's two routes agree as the JAX package's do
    (tests/test_runners_extra.py:243-261): float64 rtol 1e-6 with atol 1e-9
    of the largest value, float32 rtol 2e-2 with atol 2e-5 of it."""
    _, tm = models["log"]
    cols, m = catalog()
    t = torch_anis(tm, tm, cols, m, "auto", dt)
    s = torch_anis(tm, tm, cols, m, "scatter", dt)
    if dt == "f64":
        np.testing.assert_allclose(t, s, rtol=1e-6,
                                   atol=1e-9 * np.abs(s).max())
    else:
        np.testing.assert_allclose(t, s, rtol=2e-2,
                                   atol=2e-5 * np.abs(s).max())


def _paint2_inputs(models, kinds, dt):
    """The halo data and K12's inputs as the runner builds them."""
    cols, m = catalog()
    _, (cat, shell) = _shells(cols, m)
    tm = models[kinds[0]][1]
    tt_ = models[kinds[1]][1]
    r = bf.PaintProfilesAnisShell(cat, shell, model=tm, Tracer_model=tt_,
                                  Mtot_model=tt_, dtype=TDT[dt],
                                  device="cpu", **KW)
    hd = r._host_halo_data(bf.cosmo.cosmology_from_dict(r.cosmo))
    curves = []
    for mod in (tm, tt_):
        c, r0, dl = mod.with_dtype(torch.float64).halo_curves(hd["M"],
                                                               hd["a"])
        curves.append((c, float(r0), float(dl), mod.curves_are_log))
    return hd, r._tile_paint2_inputs(hd, curves, NSIDE)


@pytest.mark.parametrize("kinds", [("log", "log"), ("raw", "raw"),
                                   ("log", "raw")],
                         ids=["log-log", "raw-raw", "log-raw"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_tile_paint2_plain_matches_jax(models, kinds, dt):
    """tile_paint2 (CPU: the plain version of K12) on the runner's pack
    against make_tile_deposit(mode="paint2", lookup="gather") on the same
    pairs: float64 to rtol 1e-9 with equal zeros, float32 to the JAX
    bound."""
    hd, (tiling, csr, pack, grid) = _paint2_inputs(models, kinds, dt)
    tiling_j = jt.SkyTiling(NSIDE, ring_block=tiling.RB, seg_slots=tiling.K)
    st = np.sin(hd["theta"])
    vh = np.stack([st * np.cos(hd["phi"]), st * np.sin(hd["phi"]),
                   np.cos(hd["theta"])], 1)
    chord = 2.0 * np.sin(np.minimum(hd["radius"], np.pi) / 2.0)
    t_ids, h_ids = jt.bin_halos_to_tiles(tiling_j, hd["theta"], hd["phi"],
                                         hd["radius"])
    _, near = jt.refine_pairs(tiling_j, t_ids, h_ids, vh, chord)
    for a, b in zip(tt.pairs_csr(*near), csr):
        np.testing.assert_array_equal(a, b.numpy())
    ln_r0, inv, ln_r0_2, inv_2, log = grid
    run = jt.make_tile_deposit(tiling_j, pack["curves"].shape[1],
                               mode="paint2", dtype=JDT[dt], log_curves=log,
                               lookup="gather",
                               n_r2=pack["curves2"].shape[1])
    jpack = {k: jnp.asarray(v.numpy()) for k, v in pack.items()}
    jpack["invD"] = jnp.zeros_like(jpack["afac"])
    jpack["ln_r0_2"] = jnp.asarray(ln_r0_2, dtype=JDT[dt])
    jpack["inv_dlnr_2"] = jnp.asarray(inv_2, dtype=JDT[dt])
    npdt = np.dtype(JDT[dt])
    ref = np.zeros((tiling_j.n_tiles, tiling_j.RB * tiling_j.K), npdt)
    for bucket in jt.bucket_tiles(*near):
        tids, o = run(bucket, jpack, ln_r0, inv)
        np.add.at(ref, tids, np.asarray(o))
    acc = td.tile_paint2(tiling, csr, pack, *grid).numpy()
    assert acc.dtype == npdt and (ref > 0).sum() > 100
    if dt == "f64":
        np.testing.assert_allclose(acc, ref, rtol=1e-9, atol=0)
        np.testing.assert_array_equal(acc == 0, ref == 0)
    else:
        np.testing.assert_allclose(acc, ref, rtol=2e-2,
                                   atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("tiled,dt", [(True, "f64"), (True, "f32"),
                                      (False, "f64")],
                         ids=["tiled-f64", "tiled-f32", "summed-f64"])
def test_anis_finish_plain_matches_jax(tiled, dt):
    """anis_finish (CPU: the plain version of K14) against the JAX
    runners' finishing passes, written here as they are there:
    HealpixRunner.py:2349-2360 (tiled: the halo sum and the canvas in the
    runner's dtype), 2440-2443 and Map2DRunner.py:792-796 (summed: both
    float64 there); rtol 1e-15."""
    rng = np.random.default_rng(4)
    n = 5000
    hs = rng.uniform(0, 2, n).astype(JDT[dt])
    mt = rng.uniform(-0.2, 2, n).astype(JDT[dt])
    og = rng.exponential(1.0, n)
    add, bgw, scale = 0.3, 0.1, 4.0
    if tiled:
        mt2 = jnp.asarray(mt).astype(jnp.float64) + add
        good = mt2 > 0
        base = jnp.where(good, jnp.asarray(hs).astype(jnp.float64) * og / mt2,
                         0.0)
        bg = jnp.where(good, add / mt2, 0.0) * og
        ref = base + bgw * bg
    else:
        acc = jnp.asarray(hs).astype(jnp.float64) * scale
        bg = jnp.where(jnp.asarray(mt) > 0, add / jnp.asarray(mt), 0.0) * og
        ref = acc + bgw * bg
    out = paint.anis_finish(torch.as_tensor(hs), torch.as_tensor(mt),
                            torch.as_tensor(og), add, bgw, scale, tiled)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-15,
                               atol=0)


class _HideCurves:
    """Only the projected() surface of a profile: the direct readout."""

    def __init__(self, prof):
        self._prof = prof

    def projected(self, *args, **kwargs):
        return self._prof.projected(*args, **kwargs)


def test_paint_device_and_refusals(models):
    """PaintProfilesShell._paint_device keeps the map on the runner's
    device (process() is its download); the Anis runner reads a tracer
    without halo_curves directly, to the curve path's map, and raises for
    one with neither halo_curves nor projected, without the shell's
    redshift, and on the default device without CUDA."""
    _, tm = models["log"]
    cols, m = catalog(8)
    _, (cat, shell) = _shells(cols, m)
    r = bf.PaintProfilesShell(cat, shell, epsilon_max=5, model=tm,
                              include_pixel_size=True, device="cpu")
    dev_map = r._paint_device()
    assert isinstance(dev_map, torch.Tensor)
    np.testing.assert_array_equal(dev_map.numpy().astype(np.float64),
                                  r.process())
    with pytest.raises(TypeError, match="projected"):
        bf.PaintProfilesAnisShell(cat, shell, model=tm, Tracer_model=object(),
                                  Mtot_model=tm, device="cpu",
                                  **KW).process()
    # a tracer without halo_curves takes the direct readout (model and
    # tracer read per pixel), the curve path's map in float64
    kw = dict(model=tm, Mtot_model=tm, device="cpu", deposit="scatter",
              dtype=torch.float64, **KW)
    curve = bf.PaintProfilesAnisShell(cat, shell, Tracer_model=tm,
                                      **kw).process()
    direct = bf.PaintProfilesAnisShell(cat, shell,
                                       Tracer_model=_HideCurves(tm),
                                       **kw).process()
    np.testing.assert_allclose(direct, curve, rtol=1e-9,
                               atol=1e-12 * np.abs(curve).max())
    shell.redshift = None
    with pytest.raises(ValueError, match="redshift"):
        bf.PaintProfilesAnisShell(cat, shell, model=tm, Tracer_model=tm,
                                  Mtot_model=tm, device="cpu", **KW).process()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bf.PaintProfilesAnisShell(cat, shell, model=tm, Tracer_model=tm,
                                      Mtot_model=tm, **KW)
