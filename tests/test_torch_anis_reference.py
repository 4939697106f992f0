"""The anisotropic shell paint of the port (PaintProfilesAnisShell with
device="cpu", tiled and scatter) against the benchmark's plain reference
(benchmark/reference/anis.py: the upstream runner's disc scatter path in
float64), the reference's S19 Temperature and GasNumberDensity against the
port's, the Anis runner's trace keys (its canvas under ``canvas.``, the
background span, two pair searches) and the benchmark's anis_* readers on
a hand-made Context.

The three models are small TabulatedProfiles of the configuration
``anis_paint`` (benchmark/configs/anis_paint.*: Temperature(Pressure,
GasNumberDensity), Gas, DarkMatterBaryon on the S19 parameters) built by
the port on the CPU once; both sides paint from them. Tolerances:
  * float64: 1e-10 of the map's largest value (the two sum in other
    orders, over tiles or discs);
  * float32: the port's float32 paint bound of tests/test_torch_anis.py
    (rtol 2e-2, atol 2e-5 of the largest value).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch import cosmo as bcosmo               # noqa: E402
from baryonforge_torch.Profiles import Schneider19, Thermodynamic  # noqa

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness                               # noqa: E402
from benchmark import shells as S                           # noqa: E402
from benchmark.reference import anis as ref_anis            # noqa: E402
from benchmark.reference import cosmo_core                  # noqa: E402
from benchmark.reference import temperature as ref_temp     # noqa: E402
from benchmark.reference import thermodynamic as ref_thermo  # noqa: E402
from benchmark.reference import schneider19 as ref_s19      # noqa: E402

NSIDE = 64
EPS = 20
REDSHIFT = 0.12
CFG, MOD = harness.load_config("anis_paint", harness.Dirs())
GRID = dict(z_min=0.08, z_max=0.16, N_samples_z=2, z_linear_sampling=True,
            M_min=1e13, M_max=1e15, N_samples_Mass=3, R_min=1e-3, R_max=60,
            N_samples_R=12, verbose=False)
TDT = {"f32": torch.float32, "f64": torch.float64}
TRACER_FRACTION = CFG["cosmology"]["Omega_b"] / CFG["cosmology"]["Omega_m"]


@pytest.fixture(scope="module")
def tables():
    """The port's three small tables (model, tracer, Mtot)."""
    c = bcosmo.cosmology_from_dict(S.cosmo_dict(CFG))
    return [bf.utils.TabulatedProfile(p, c, device="cpu")
            .setup_interpolator(**GRID)
            for p in MOD._profiles(Schneider19, Thermodynamic, Thermodynamic,
                                   CFG)]


def _shell(n=24, seed=27):
    rng = np.random.default_rng(seed)
    return dict(ra=rng.uniform(0, 360, n),
                dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
                M=10 ** rng.uniform(13.3, 14.9, n),
                z=rng.uniform(0.10, 0.14, n),
                map=rng.exponential(1.0, 12 * NSIDE ** 2))


def _port(tables, shell, deposit, dt, background_val):
    cd = S.cosmo_dict(CFG)
    cat = bf.utils.HaloLightConeCatalog(ra=shell["ra"], dec=shell["dec"],
                                        M=shell["M"], z=shell["z"], cosmo=cd)
    sh = bf.utils.LightconeShell(map=shell["map"], cosmo=cd,
                                 redshift=REDSHIFT)
    model, tracer, mtot = tables
    return bf.PaintProfilesAnisShell(
        cat, sh, epsilon_max=EPS, model=model, Tracer_model=tracer,
        Mtot_model=mtot, background_val=background_val,
        global_tracer_fraction=TRACER_FRACTION, deposit=deposit,
        dtype=TDT[dt], device="cpu")


def _reference(tables, shell, background_val):
    cosmo = cosmo_core.cosmology_from_dict(S.cosmo_dict(CFG))
    halos = S.reference_halos(cosmo, shell, EPS, "cpu")
    axes = tuple(getattr(tables[0], f"raw_input_{k}_range")
                 for k in ("z", "M", "r"))
    painting, tracer, mtot = (
        S.reference_curves(t.raw_input_2D, axes, halos, torch.float64,
                           -np.inf) for t in tables)
    out, share = ref_anis.anis_paint_plain(
        NSIDE, halos, painting, tracer, mtot,
        torch.as_tensor(shell["map"]), cosmo, REDSHIFT,
        CFG["profile_params"]["proj_cutoff"],
        background_val * TRACER_FRACTION, torch.float64)
    return out.numpy(), share


@pytest.mark.parametrize("deposit", ["auto", "scatter"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_anis_shell_matches_the_reference(tables, deposit, dt):
    """The port's runner, tiled (K10 canvas, K12, K14) and scatter (K11
    canvas, K13, K14), against the reference's disc walk in float64: with
    the configuration's background (which leads the map at this NSIDE's
    large pixels) and without one (the halo sum alone); the halos are a
    small share of rho_m."""
    shell = _shell()
    for bg in (CFG["runner"]["background_val"], 0.0):
        ref, share = _reference(tables, shell, bg)
        out = _port(tables, shell, deposit, dt, bg).process()
        assert out.dtype == np.float64 and out.shape == ref.shape
        assert 0 < share < 0.5 and np.count_nonzero(ref) > 300
        scale = np.abs(ref).max()
        if dt == "f64":
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10 * scale)
        else:
            np.testing.assert_allclose(out, ref, rtol=2e-2,
                                       atol=2e-5 * scale)


@pytest.mark.parametrize("kind", ["Temperature", "GasNumberDensity"])
def test_reference_profiles_match_the_port(kind):
    """benchmark/reference/temperature.py's profiles, real and projected,
    against the port's in float64 (the same S19 pressure and gas)."""
    def make(*modules):
        temp = MOD._profiles(*modules, CFG)[0]
        return temp if kind == "Temperature" else temp.GasNumberDensity
    port = make(Schneider19, Thermodynamic, Thermodynamic)
    ref = make(ref_s19, ref_thermo, ref_temp)
    cp = bcosmo.cosmology_from_dict(S.cosmo_dict(CFG))
    cr = cosmo_core.cosmology_from_dict(S.cosmo_dict(CFG))
    r = torch.tensor([0.01, 0.5, 20.0], dtype=torch.float64)
    M = torch.tensor([3e13, 4e14], dtype=torch.float64)
    for name in ("real", "projected"):
        a = getattr(port, name)(cp, r, M, 0.9)
        b = getattr(ref, name)(cr, r, M, 0.9)
        assert torch.isfinite(b).all() and (b > 0).all()
        torch.testing.assert_close(a, b, rtol=1e-10, atol=0)


def test_anis_shell_records_its_keys(tables):
    """The tiled call's canvas records its host work under ``canvas.``
    (its pair search apart from the halo sum's), the background its span,
    and the call counts its two pair searches; the scatter call makes
    none."""
    shell = _shell()
    bg = CFG["runner"]["background_val"]
    r = _port(tables, shell, "auto", "f32", bg)
    r.process()
    t = r.timings
    assert [k for k in t if "." not in k] == [
        "host_prep", "canvas", "curves", "binning", "paint", "finish",
        "download"]
    pair_keys = {"binning.bin", "binning.refine", "binning.csr",
                 "binning.pack", "binning.tiling", "count.pairs",
                 "count.pairs_kept", "copy.h2d", "count.h2d_bytes"}
    assert pair_keys <= set(t)
    assert {"canvas." + k for k in pair_keys if not k.startswith("count.")
            } <= set(t)
    assert {"count.canvas." + k[len("count."):] for k in pair_keys
            if k.startswith("count.")} <= set(t)
    assert "anis.background" in t and t["count.pair_searches"] == 2
    assert t["count.canvas.pairs"] == t["count.pairs"]
    assert not any(k.startswith("canvas.canvas.") for k in t)
    s = _port(tables, shell, "scatter", "f32", bg)
    s.process()
    assert "count.pair_searches" not in s.timings
    assert "anis.background" in s.timings


# ---- the benchmark's anis_* readers -----------------------------------------
def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "anis_ref_test_metric_" + name.replace(".", "_"),
        os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Context:
    """The part of benchmark.harness.Context that the readers read."""

    def __init__(self, units, op_seconds=None):
        self.units = units
        self.cfg = CFG
        self.shells = [dict(M=np.ones(1000))] * 2
        self.trace = (None if op_seconds is None
                      else dict(op_seconds=op_seconds))

    def done(self):
        return [u for u in self.units if u["ok"]]

    def timing_ms(self, *keys):
        vals = [sum(u["timings"][k] for k in keys if k in u["timings"])
                for u in self.done()
                if any(k in u["timings"] for k in keys)]
        return float(np.mean(vals)) if vals else None

    def members(self, i):
        return 2e6 * (i + 1)

    def device_seconds(self, patterns):
        if self.trace is None:
            return None
        s = sum(t for n, t in self.trace["op_seconds"].items()
                if any(p in n for p in patterns))
        return s if s > 0 else None


PAIRS = ("binning.bin", "binning.refine", "binning.csr")
UNITS = [
    dict(ok=True, shell=0, timings=dict(
        {"canvas": 200.0, "curves": 3.0, "paint": 2.0, "finish": 0.25,
         "anis.background": 0.5},
        **{k: 10.0 for k in PAIRS}, **{"canvas." + k: 20.0 for k in PAIRS})),
    dict(ok=True, shell=1, timings=dict(
        {"canvas": 100.0, "curves": 5.0, "paint": 4.0, "finish": 0.75,
         "anis.background": 0.5},
        **{k: 30.0 for k in PAIRS}, **{"canvas." + k: 40.0 for k in PAIRS})),
    dict(ok=False, shell=1, timings={"canvas": 1e6, "anis.background": 1.0}),
]
# the window's device seconds by kernel: the readers' kernels and others
OPS = {"collapse_curves_kernel": 1e-4, "tile_pairs_kernel": 4e-4,
       "layout_kernel": 2e-4, "anis_finish_kernel": 3e-4,
       "reduce_kernel": 9.0, "Memcpy DtoH (Device -> Pageable)": 9.0}


def _least(b, ops, dt):
    return max(b / 3.35e12, ops / {"float32": 67e12, "float64": 34e12}[dt])


def _want_paint():
    """The canvas (14 operations a member, its table in f32) and the halo
    sum (20, both tables in f64), counted here from the formulas; NSIDE
    1024's f32 maps, 1000 halos of 32 bytes, 3 x 12 x 64 table values."""
    npix, tv = 12 * 1024 ** 2, 3 * 12 * 64
    return sum(_least(2 * (1000 * 32 + npix * 4) + tv * 4 + 2 * tv * 8,
                      m * 34, "float32") for m in (2e6, 4e6))


def _want_finish():
    return 2 * _least(12 * 1024 ** 2 * 24, 12 * 1024 ** 2 * 7, "float64")


@pytest.mark.parametrize("name,want", [
    ("anis_canvas_ms", 150.0),
    ("anis_pairs_ms", (90.0 + 210.0) / 2),
    ("anis_paint_ms", (5.0 + 9.0) / 2),
    ("anis_finish_ms", 0.5),
    ("roofline_pct.anis_paint", "paint"),
    ("roofline_pct.anis_finish", "finish")])
def test_anis_metric_readers(name, want):
    """Each anis_* reader's value on a hand-made window (the failed call
    left out), and None where the calls lack the anisotropic paint's
    spans (the parent's program) or the window has no trace."""
    if want == "paint":
        want = 100.0 * _want_paint() / 7e-4
    elif want == "finish":
        want = 100.0 * _want_finish() / 3e-4
    read = _reader(name)
    assert read(_Context(UNITS, OPS)) == pytest.approx(want, rel=1e-12)
    parent = [dict(u, timings={k: v for k, v in u["timings"].items()
                               if not k.startswith(("canvas.", "anis."))})
              for u in UNITS]
    assert read(_Context(parent, OPS)) is None
    assert read(_Context([], OPS)) is None
    if name.startswith("roofline"):
        assert read(_Context(UNITS)) is None
        assert 0 < read(_Context(UNITS, OPS)) <= 100
