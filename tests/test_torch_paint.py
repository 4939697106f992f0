"""The paint of the torch port (plain versions of kernels K10 and K11 on the
CPU, and PaintProfilesShell with device="cpu") against baryonforge_tpu.

The model is the bench's tSZ table, TabulatedProfile(ThermalSZ(Pressure(
**bpar, proj_cutoff=100), proj_cutoff=100)) at 8 z x 20 M x 64 r, as the
JAX package built and saved it (tests/data/tsz_bench_table.npz), loaded
into both packages; its raw form (exp of the log tables, as a
ParamTabulatedProfile without parameter axes) runs the raw-curve
branches. Tolerances:
  * float64: rtol 1e-9 per pixel (the packages' sums run in other orders;
    the tile and disc geometry agrees to the last bits);
  * float32 (the bench's dtypes): the JAX package's own bound between its
    tiled and scatter paint (tests/test_tiled_deposit.py:113, atol 2e-3 of
    the largest pixel and rtol 2e-3): a pixel on a disc edge can flip in
    or out in float32;
  * the port's tiled and scatter paint: that bound too.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Runners as JRunners             # noqa: E402
from baryonforge_tpu import utils as JUtils                 # noqa: E402
from baryonforge_tpu.cosmo import core as jcore             # noqa: E402
from baryonforge_tpu.cosmo import massdef as jmassdef       # noqa: E402
from baryonforge_tpu.ops import tiles as jt                 # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import tiles as tt               # noqa: E402
from baryonforge_torch.ops import paint                     # noqa: E402
from baryonforge_torch.ops.paint import disc_paint          # noqa: E402
from baryonforge_torch.ops.tile_deposit import tile_paint   # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from test_torch_curves import COSMO_DICT                    # noqa: E402

TSZ_TABLE = os.path.join(os.path.dirname(__file__), "data",
                         "tsz_bench_table.npz")
NSIDE = 128
# discs of a few pixels, as the bench's at NSIDE 1024 with eps_max 5
EPS = 40
JDT = {"f32": jnp.float32, "f64": jnp.float64}
TDT = {"f32": torch.float32, "f64": torch.float64}


@pytest.fixture(autouse=True)
def _fresh_geometry_cache():
    """Each test starts and ends with the port's process-wide geometry
    cache empty (ops.geometry), so that a fresh runner's fills do not
    depend on which tests ran before it in the same worker."""
    bf.clear_geometry_cache()
    yield
    bf.clear_geometry_cache()


def jax_tables():
    """The JAX tSZ table (log curves) and its raw form (raw curves)."""
    jc = jcore.cosmology_from_dict(COSMO_DICT)
    log_tab = JUtils.TabulatedProfile(None, jc, mass_def=jmassdef.MassDef200c)
    log_tab.load_table(TSZ_TABLE)
    raw_tab = JUtils.ParamTabulatedProfile(None, jc,
                                           mass_def=jmassdef.MassDef200c)
    raw_tab._axes = log_tab._axes
    raw_tab._tab3D = jnp.exp(log_tab._tab3D)
    raw_tab._tab2D = jnp.exp(log_tab._tab2D)
    return {"log": log_tab, "raw": raw_tab}


@pytest.fixture(scope="module")
def models():
    j = jax_tables()
    return {k: (v, convert.tabulated_from_jax(v, device="cpu"))
            for k, v in j.items()}


def catalog(n=50, seed=5, n_cap=12):
    """Bench-like halos (bench.py:94-102) with two at dec +-89.5, ``n_cap``
    near the caps and two off the table's mass range (they paint
    nothing): numpy columns."""
    rng = np.random.default_rng(seed)
    n_cap = min(n_cap, n - 4)
    ra = rng.uniform(0, 360, n)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    dec[2:2 + n_cap] = rng.uniform(77, 84, n_cap) * rng.choice([-1, 1], n_cap)
    dec[0], dec[1] = 89.5, -89.5
    M = 10 ** rng.uniform(13.0, 14.8, n)
    M[-2:] = [2e12, 5e15]
    z = rng.uniform(0.8, 1.0, n)
    return dict(ra=ra, dec=dec, M=M, z=z)


def _jax_inputs(cols, nside=NSIDE):
    return (JUtils.HaloLightConeCatalog(**cols, cosmo=COSMO_DICT),
            JUtils.LightconeShell(map=np.zeros(12 * nside ** 2),
                                  cosmo=COSMO_DICT))


def _torch_inputs(cols, nside=NSIDE):
    return (bf.utils.HaloLightConeCatalog(**cols, cosmo=COSMO_DICT),
            bf.utils.LightconeShell(map=np.zeros(12 * nside ** 2),
                                    cosmo=COSMO_DICT))


def jax_paint(model, cols, deposit, dt, rdt, pix, eps=EPS):
    """The JAX runner's painted map. Its scatter path gets one radius
    bucket and distinct batch shapes per colatitude class: it caches the
    compiled body by batch shape alone (ROADMAP Queue 3)."""
    cat, shell = _jax_inputs(cols)
    jr = JRunners.PaintProfilesShell(
        cat, shell, epsilon_max=eps, model=model, deposit=deposit,
        dtype=JDT[dt], regrid_dtype=JDT[rdt], include_pixel_size=pix,
        n_size_buckets=1, verbose=False)
    if deposit == "scatter":
        jr._refresh_tokens(need_map=False)
        hd = jr._host_halo_data(jcore.cosmology_from_dict(jr.cosmo))
        curves = np.zeros((hd["M"].size, 64))
        shapes = [b[0].shape for _, _, b in
                  jr._prepare_groups(hd, [curves], shell.NSIDE)]
        assert len(set(shapes)) == len(shapes), shapes
    return np.asarray(jr.process(), dtype=np.float64)


def torch_paint(model, cols, deposit, dt, rdt, pix, eps=EPS, runner=False):
    cat, shell = _torch_inputs(cols)
    r = bf.PaintProfilesShell(cat, shell, epsilon_max=eps, model=model,
                              deposit=deposit, dtype=TDT[dt],
                              regrid_dtype=TDT[rdt], include_pixel_size=pix,
                              device="cpu")
    out = r.process()
    return (out, r) if runner else out


def _f64_close(t, j):
    assert j.max() > 0 and (j > 0).sum() > 100
    np.testing.assert_allclose(t, j, rtol=1e-9, atol=1e-12 * j.max())


def _paint_bound(a, b):
    """tests/test_tiled_deposit.py:113."""
    assert b.max() > 0
    np.testing.assert_allclose(a, b, atol=2e-3 * np.abs(b).max(), rtol=2e-3)


@pytest.mark.parametrize("deposit", ["tiles", "scatter"])
@pytest.mark.parametrize("pix", [False, True], ids=["value", "pixel_size"])
def test_paint_shell_f64_matches_jax(models, deposit, pix):
    """float64 paint and accumulator, log curves: rtol 1e-9 per pixel."""
    jm, tm = models["log"]
    cols = catalog()
    _build.reset_launches()
    out_t, r = torch_paint(tm, cols, deposit, "f64", "f64", pix,
                           runner=True)
    assert not _build.launches        # CPU: the plain versions
    assert out_t.dtype == np.float64 and out_t.shape == (12 * NSIDE ** 2,)
    _f64_close(out_t, jax_paint(jm, cols, deposit, "f64", "f64", pix))
    phases = {"host_prep", "curves", "paint", "download"}
    assert {k for k in r.timings if "." not in k} == (
        phases | {"binning"} if deposit == "tiles" else phases)
    spans = {"host_prep.cosmology", "host_prep.columns", "download.wait",
             "download.convert", "copy.h2d", "copy.d2h", "count.h2d_bytes",
             "count.d2h_bytes"}
    if deposit == "tiles":
        spans |= {"binning.pack", "binning.tiling", "binning.bin",
                  "binning.refine", "binning.csr", "cache.tiling",
                  "cache.crad", "count.pairs", "count.pairs_kept"}
    assert spans <= set(r.timings)


@pytest.mark.parametrize("deposit", ["tiles", "scatter"])
def test_paint_shell_raw_curves_match_jax(models, deposit):
    """Raw curves (ParamTabulatedProfile): the same map as the log table's
    to the lerp's difference, and the JAX map to rtol 1e-9."""
    jm, tm = models["raw"]
    cols = catalog()
    out_t = torch_paint(tm, cols, deposit, "f64", "f64", False)
    _f64_close(out_t, jax_paint(jm, cols, deposit, "f64", "f64", False))


@pytest.mark.parametrize("deposit", ["tiles", "scatter"])
def test_paint_shell_bench_dtypes_match_jax(models, deposit):
    """The bench's float32 paint and float32 accumulator, against the JAX
    float32 map and the JAX float64 map."""
    jm, tm = models["log"]
    cols = catalog()
    out_t = torch_paint(tm, cols, deposit, "f32", "f32", True)
    assert np.isfinite(out_t).all()
    _paint_bound(out_t, jax_paint(jm, cols, deposit, "f32", "f32", True))
    _paint_bound(out_t, jax_paint(jm, cols, deposit, "f64", "f64", True))


def test_paint_16x32_tiling_matches_jax(models, monkeypatch):
    """The 16 x 32 tiling (large discs; here forced on both sides: the JAX
    runner's BFG_PAINT_TILING=default, the port's _paint_tiling)."""
    jm, tm = models["log"]
    cols = catalog()
    monkeypatch.setenv("BFG_PAINT_TILING", "default")
    monkeypatch.setattr(bf.PaintProfilesShell, "_paint_tiling",
                        lambda self, nside, hd: self._get_tiling(nside))
    _f64_close(torch_paint(tm, cols, "tiles", "f64", "f64", False),
               jax_paint(jm, cols, "tiles", "f64", "f64", False))


def test_paint_tiling_rule_matches_jax():
    """The auto rule: 8 x 16 when the median disc diameter is under 1.5
    heights of a 16 x 32 tile, else 16 x 32."""
    cat, shell = _torch_inputs(catalog(8))
    r = bf.PaintProfilesShell(cat, shell, epsilon_max=5, model=None,
                              device="cpu")
    jcat, jshell = _jax_inputs(catalog(8))
    jr = JRunners.PaintProfilesShell(jcat, jshell, epsilon_max=5,
                                     model=None, verbose=False)
    for nside in (64, 1024):
        tile_th = 16.0 * np.pi / (4.0 * nside)
        for rad in (0.2 * tile_th, 0.74 * tile_th, 0.76 * tile_th):
            hd = {"radius": np.full(9, rad)}
            t, j = r._paint_tiling(nside, hd), jr._paint_tiling(nside, hd)
            assert (t.RB, t.K) == (j.RB, j.K)
            assert (t.RB, t.K) == ((8, 16) if rad < 0.75 * tile_th
                                   else (16, 32))


def test_tiled_and_scatter_agree_and_single_halo(models):
    """The port's tiled and disc paint agree to the JAX package's bound
    (with include_pixel_size, as tests/test_tiled_deposit.py:113), and one
    halo's painted pixels are tab.projected at their distances (rtol
    1e-2, tests/test_healpix_runner.py:100-129)."""
    _, tm = models["log"]
    cols = catalog()
    _paint_bound(torch_paint(tm, cols, "tiles", "f32", "f64", True),
                 torch_paint(tm, cols, "scatter", "f32", "f64", True))
    one = dict(ra=np.array([40.0]), dec=np.array([10.0]),
               M=np.array([1e15]), z=np.array([0.9]))
    out = torch_paint(tm, one, "auto", "f64", "f64", False)
    a = 1 / 1.9
    cosmo = bf.cosmo.cosmology_from_dict(COSMO_DICT)
    D = float(bf.cosmo.core.angular_diameter_distance(cosmo, a)[0])
    theta0, phi0 = np.radians(80.0), np.radians(40.0)
    sel = np.where(out > 0)[0]
    assert sel.size > 10
    th, ph = bf.ops.healpix.pix2ang(NSIDE, torch.as_tensor(sel,
                                                           dtype=torch.int32))
    th, ph = th.numpy(), ph.numpy()
    vec = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                    np.cos(th)], 1)
    c = np.array([np.sin(theta0) * np.cos(phi0),
                  np.sin(theta0) * np.sin(phi0), np.cos(theta0)])
    r_sep = np.linalg.norm(vec - c, axis=1) * D
    expect = tm.projected(None, r_sep / a, 1e15, a).numpy()
    np.testing.assert_allclose(out[sel], expect, rtol=1e-2)


def _tile_inputs(model, tiling_j, dt, nside=NSIDE):
    """The tile paint's pack and pairs as the runner builds them, from the
    catalog's halos (float64 numpy), with the JAX buckets of the same
    pairs."""
    cols = catalog()
    cat, shell = _torch_inputs(cols, nside)
    r = bf.PaintProfilesShell(cat, shell, epsilon_max=EPS, model=model,
                              dtype=TDT[dt], device="cpu")
    hd = r._host_halo_data(bf.cosmo.cosmology_from_dict(r.cosmo))
    curves, ln_r0, dlnr = model.with_dtype(TDT[dt]).halo_curves(hd["M"],
                                                                hd["a"])
    log = model.curves_are_log
    curves = (torch.clamp(curves, min=-80.0) if log else curves)
    st = np.sin(hd["theta"])
    vh = np.stack([st * np.cos(hd["phi"]), st * np.sin(hd["phi"]),
                   np.cos(hd["theta"])], 1)
    chord = 2.0 * np.sin(np.minimum(hd["radius"], np.pi) / 2.0)
    pack = dict(vh=vh, crit2=chord ** 2, lnDa=np.log(hd["D"] / hd["a"]),
                afac=1.0 / hd["a"])
    t_ids, h_ids = jt.bin_halos_to_tiles(tiling_j, hd["theta"], hd["phi"],
                                         hd["radius"])
    _, near = jt.refine_pairs(tiling_j, t_ids, h_ids, vh, chord)
    return pack, curves, near, float(ln_r0), 1.0 / float(dlnr), log


@pytest.mark.parametrize("shape", [(8, 16), (16, 32)],
                         ids=["tile8x16", "tile16x32"])
@pytest.mark.parametrize("kind", ["log", "raw"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_tile_paint_plain_matches_jax(models, shape, kind, dt):
    """tile_paint (CPU: the plain version of K10) against
    make_tile_deposit(mode="paint", lookup="gather") on the same pairs:
    float64 to rtol 1e-9, float32 to the JAX package's bound; equal zeros
    where nothing is painted."""
    _, tm = models[kind]
    tiling_j = jt.SkyTiling(NSIDE, ring_block=shape[0], seg_slots=shape[1])
    pack, curves, near, ln_r0, inv, log = _tile_inputs(tm, tiling_j, dt)
    npdt = np.dtype(JDT[dt])
    run = jt.make_tile_deposit(tiling_j, curves.shape[1], mode="paint",
                               dtype=JDT[dt], log_curves=log,
                               lookup="gather")
    jpack = {k: jnp.asarray(v if k == "vh" else v.astype(npdt))
             for k, v in pack.items()}
    jpack["invD"] = jnp.zeros_like(jpack["afac"])
    jpack["curves"] = jnp.asarray(curves.numpy())
    ref = np.zeros((tiling_j.n_tiles, tiling_j.RB * tiling_j.K), npdt)
    for bucket in jt.bucket_tiles(*near):
        tids, out = run(bucket, jpack, ln_r0, inv)
        np.add.at(ref, tids, np.asarray(out))
    tiling = tt.SkyTiling(NSIDE, ring_block=shape[0], seg_slots=shape[1])
    csr = tuple(torch.as_tensor(x) for x in tt.pairs_csr(*near))
    tpack = {k: torch.as_tensor(v, dtype=torch.float64 if k == "vh"
                                else TDT[dt]) for k, v in pack.items()}
    tpack["curves"] = curves
    acc = tile_paint(tiling, csr, tpack, ln_r0, inv, log).numpy()
    assert acc.dtype == npdt and acc.shape == ref.shape
    assert (ref > 0).sum() > 100
    if dt == "f64":
        np.testing.assert_allclose(acc, ref, rtol=1e-9, atol=0)
        np.testing.assert_array_equal(acc == 0, ref == 0)
    else:
        _paint_bound(acc, ref)


@pytest.mark.parametrize("kind", ["log", "raw"])
@pytest.mark.parametrize("pix", [False, True], ids=["value", "pixel_size"])
def test_disc_paint_plain_matches_jax(models, kind, pix):
    """disc_paint (CPU: the plain version of K11) on the runner's halo
    columns and curves, against the JAX scatter paint, float64."""
    jm, tm = models[kind]
    cols = catalog()
    cat, shell = _torch_inputs(cols)
    r = bf.PaintProfilesShell(cat, shell, epsilon_max=EPS, model=tm,
                              dtype=torch.float64, device="cpu")
    hd = r._host_halo_data(bf.cosmo.cosmology_from_dict(r.cosmo))
    halos = {k: torch.as_tensor(hd[k]) for k in
             ("theta", "phi", "radius", "D", "a")}
    curves, ln_r0, dlnr = tm.halo_curves(hd["M"], hd["a"])
    acc = disc_paint(NSIDE, halos, curves, ln_r0, dlnr, tm.curves_are_log,
                     pix, torch.float64).numpy()
    _f64_close(acc, jax_paint(jm, cols, "scatter", "f64", "f64", pix))
    acc32 = disc_paint(NSIDE, halos, curves, ln_r0, dlnr, tm.curves_are_log,
                       pix, torch.float32)
    assert acc32.dtype == torch.float32
    _paint_bound(acc32.numpy(), acc)


class _HideCurves:
    """Only the projected() surface of a profile: the direct readout."""

    def __init__(self, prof):
        self._prof = prof

    def projected(self, *args, **kwargs):
        return self._prof.projected(*args, **kwargs)


def test_paint_needs_curves_and_cuda(models):
    """A model without halo_curves is read directly (ops.direct) and
    paints the curve path's map (float64, 1e-9 per pixel); one with neither
    halo_curves nor projected raises, naming projected; the runner runs on
    CUDA by default and raises without it."""
    cat, shell = _torch_inputs(catalog())
    tm = models["log"][1]
    kw = dict(epsilon_max=EPS, dtype=torch.float64, deposit="scatter",
              device="cpu")
    curve = bf.PaintProfilesShell(cat, shell, model=tm, **kw).process()
    direct = bf.PaintProfilesShell(cat, shell, model=_HideCurves(tm),
                                   **kw).process()
    _f64_close(direct, curve)
    cat, shell = _torch_inputs(catalog(8))
    with pytest.raises(TypeError, match="projected"):
        bf.PaintProfilesShell(cat, shell, epsilon_max=5, model=object(),
                              device="cpu").process()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bf.PaintProfilesShell(cat, shell, epsilon_max=5, model=None)


def test_float32_tolerance_holds_ulp_moves_and_catches_missing_halos(models):
    """ops.paint.float32_tolerance, the per-pixel bound that K10 and K11
    are held to in float32 against their plain versions: the float32 disc
    paint with every halo moved by one float32 ulp in colatitude stays
    within it, and the same paint with the lightest fifth of the halos
    left out does not."""
    from test_torch_cuda import _paint_f32_close

    _, tm = models["log"]
    cols = catalog(200)
    cat, shell = _torch_inputs(cols)
    r = bf.PaintProfilesShell(cat, shell, epsilon_max=EPS, model=tm,
                              dtype=torch.float32, device="cpu")
    hd = r._host_halo_data(bf.cosmo.cosmology_from_dict(r.cosmo))
    halos = {k: torch.as_tensor(hd[k]) for k in paint.HALO_COLUMNS}
    curves, ln_r0, dlnr = tm.with_dtype(torch.float32).halo_curves(hd["M"],
                                                                   hd["a"])
    ln_r0, dlnr = float(ln_r0), float(dlnr)

    def run(h, c):
        return disc_paint(NSIDE, h, c, ln_r0, dlnr, True, False,
                          torch.float64)

    base = run(halos, curves)
    th32 = hd["theta"].astype(np.float32)
    moved = dict(halos, theta=torch.as_tensor(
        np.nextafter(th32, np.float32(np.pi)).astype(np.float64)))
    tol = paint.float32_tolerance(NSIDE, halos, curves, ln_r0, dlnr, True)
    assert (tol[0][base != 0] >= 1e-4).all()
    _paint_f32_close(run(moved, curves), base, *tol)
    light = torch.as_tensor(hd["M"] <= np.quantile(hd["M"], 0.2))
    dropped = torch.where(light[:, None], torch.full_like(curves, -np.inf),
                          curves)
    with pytest.raises(AssertionError):
        _paint_f32_close(run(halos, dropped), base, *tol)
