"""The shell runners' direct readout (models without halo_curves) against
the JAX runners' direct branch, on the CPU: BaryonifyShell (the plain
versions of K20, K21 and K3), PaintProfilesShell and PaintProfilesAnisShell
(K20, K21, K14), each given a model wrapped as tests/test_runners_extra.py:
201-208 wraps one, with the same numpy-seeded catalogs.

Tolerances: float64 per pixel to 1e-9 of the largest pixel change
(BaryonifyShell, tests/test_tiled_deposit.py:80) or rtol 1e-9 (the paints,
tests/test_torch_paint.py:10-17); the float32 displacement within the JAX
package's edge-jitter bounds (tests/test_tiled_deposit.py:53-63), and its
error against the float64 map at most 1.25 times the JAX float32 error
(ROADMAP Queue 3, "XLA float32 fusion"). Each JAX runner gets one size
bucket (its scatter scan is keyed on the batch shapes, not the disc window:
ROADMAP Queue 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Runners as JRunners             # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import direct                    # noqa: E402
from baryonforge_torch.ops import healpix as hpx            # noqa: E402

from test_torch_curves import COSMO_DICT, jax_model, torch_model  # noqa
from test_torch_deposit import make_inputs                  # noqa: E402
from test_torch_paint import jax_tables, _jax_inputs       # noqa: E402
from test_torch_paint import _torch_inputs as paint_inputs  # noqa: E402
from test_torch_paint import catalog as paint_catalog       # noqa: E402
from test_torch_shell import _torch_inputs                  # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

NSIDE = 64
JDT = {"f32": jnp.float32, "f64": jnp.float64}
TDT = {"f32": torch.float32, "f64": torch.float64}


class HideCurves:
    """Only a model's readout surface (tests/test_runners_extra.py:201-208,
    with displacement too): the runners of either package read it
    directly."""

    def __init__(self, model):
        self._m = model
        self.p_keys = list(getattr(model, "p_keys", []))

    def displacement(self, *args, **kwargs):
        return self._m.displacement(*args, **kwargs)

    def projected(self, *args, **kwargs):
        return self._m.projected(*args, **kwargs)


@pytest.fixture(scope="module")
def shell_runs():
    """The JAX direct shell at float64 and float32 deposit (float64
    regrid), on a catalog with polar, near-cap and fallback halos."""
    cat, shell = make_inputs(NSIDE, 120, seed=3, low_mass=True, n_cap=16)
    out = {}
    for dt in ("f64", "f32"):
        out[dt] = JRunners.BaryonifyShell(
            cat, shell, epsilon_max=20, model=HideCurves(jax_model()),
            dtype=JDT[dt], n_size_buckets=1, verbose=False).process()
    return cat, shell, out


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_direct_shell_matches_jax(shell_runs, dt):
    """BaryonifyShell with a model that has only ``displacement``."""
    cat, shell, jout = shell_runs
    tcat, tshell = _torch_inputs(cat, shell)
    runner = bf.BaryonifyShell(tcat, tshell, epsilon_max=20,
                               model=HideCurves(torch_model()),
                               dtype=TDT[dt], device="cpu")
    out = runner.process()
    orig = np.asarray(shell.map)
    np.testing.assert_allclose(out.sum(), orig.sum(), rtol=1e-10)
    assert {k for k in runner.timings if "." not in k} == {
        "host_prep", "radii", "readout", "apply", "regrid", "download"}
    assert {"host_prep.cosmology", "host_prep.columns", "copy.h2d",
            "copy.d2h", "process.check"} <= set(runner.timings)
    scale = np.abs(jout["f64"] - orig).max()
    assert scale > 0
    if dt == "f64":
        np.testing.assert_allclose(out, jout["f64"], rtol=0,
                                   atol=1e-9 * scale)
        return
    np.testing.assert_allclose(out, jout["f32"], atol=0.02 * scale)
    err_t = np.abs(out - jout["f64"])
    err_j = np.abs(jout["f32"] - jout["f64"])
    assert err_t.sum() <= 1.25 * err_j.sum() + 1e-12 * scale
    assert err_t.max() <= 1.25 * err_j.max() + 1e-12 * scale


def test_direct_shell_equals_curve_path():
    """On the CPU the direct readout of a table equals its curve path (the
    multilinear readout factorises axis by axis): float64, bitwise up to
    the order of the deposit's sums."""
    cat, shell = make_inputs(NSIDE, 80, seed=5, low_mass=True, n_cap=8)
    tcat, tshell = _torch_inputs(cat, shell)
    kw = dict(epsilon_max=20, dtype=torch.float64, deposit="scatter",
              regrid="scatter", device="cpu")
    curve = bf.BaryonifyShell(tcat, tshell, model=torch_model(),
                              **kw).process()
    direct_ = bf.BaryonifyShell(tcat, tshell,
                                model=HideCurves(torch_model()),
                                **kw).process()
    scale = np.abs(curve - np.asarray(shell.map)).max()
    np.testing.assert_allclose(direct_, curve, rtol=0, atol=1e-12 * scale)


@pytest.fixture(scope="module")
def tsz():
    """The bench's tSZ table in both packages (log curves)."""
    j = jax_tables()["log"]
    return j, convert.tabulated_from_jax(j, device="cpu")


@pytest.mark.parametrize("pix", [False, True], ids=["value", "pixel_size"])
def test_direct_paint_matches_jax(tsz, pix):
    """PaintProfilesShell with a model that has only ``projected``,
    float64."""
    jm, tm = tsz
    cols = paint_catalog(40)
    jcat, jshell = _jax_inputs(cols)
    jout = JRunners.PaintProfilesShell(
        jcat, jshell, epsilon_max=40, model=HideCurves(jm),
        dtype=jnp.float64, include_pixel_size=pix, n_size_buckets=1,
        verbose=False).process()
    tcat, tshell = paint_inputs(cols)
    out = bf.PaintProfilesShell(tcat, tshell, epsilon_max=40,
                                model=HideCurves(tm), dtype=torch.float64,
                                include_pixel_size=pix,
                                device="cpu").process()
    jout = np.asarray(jout)
    assert jout.max() > 0 and (jout > 0).sum() > 100
    np.testing.assert_allclose(out, jout, rtol=1e-9,
                               atol=1e-12 * jout.max())


def test_direct_anis_shell_matches_jax(tsz):
    """PaintProfilesAnisShell with a model and a tracer that have only
    ``projected`` (the JAX runner's scatter fallback), float64."""
    jm, tm = tsz
    jm.proj_cutoff = tm.proj_cutoff = 100
    cols = paint_catalog(40)
    jcat, jshell = _jax_inputs(cols)
    rng = np.random.default_rng(9)
    m = rng.exponential(1.0, jshell.map.size)
    jshell.map, jshell.redshift = m, 0.9
    kw = dict(epsilon_max=40, background_val=1.0,
              global_tracer_fraction=0.1)
    jout = np.asarray(JRunners.PaintProfilesAnisShell(
        jcat, jshell, model=HideCurves(jm), Tracer_model=HideCurves(jm),
        Mtot_model=jm, dtype=jnp.float64, deposit="scatter",
        n_size_buckets=1, verbose=False, **kw).process())
    tcat, tshell = paint_inputs(cols)
    tshell = bf.utils.LightconeShell(map=m, cosmo=tshell.cosmology,
                                     redshift=0.9)
    out = bf.PaintProfilesAnisShell(
        tcat, tshell, model=HideCurves(tm), Tracer_model=HideCurves(tm),
        Mtot_model=tm, dtype=torch.float64, deposit="scatter", device="cpu",
        **kw).process()
    np.testing.assert_allclose(out, jout, rtol=1e-9,
                               atol=1e-12 * np.abs(jout).max())


class _Unbatchable:
    """A readout that leaves torch: it cannot run under torch.func.vmap."""

    def __init__(self, model):
        self._m = model

    def displacement(self, r, M, a, **kw):
        return torch.as_tensor(np.asarray(self._m.displacement(
            r, float(M), a, **kw)))


def test_unbatchable_model_raises_the_contract():
    """A model whose readout cannot be vmapped raises ReadoutContractError
    (a TypeError) that states the contract; there is no loop over the
    halos to fall back to."""
    cat, shell = make_inputs(32, 10, seed=1)
    tcat, tshell = _torch_inputs(cat, shell)
    runner = bf.BaryonifyShell(tcat, tshell, epsilon_max=20,
                               model=_Unbatchable(torch_model()),
                               device="cpu")
    with pytest.raises(direct.ReadoutContractError,
                       match="torch.func.vmap.*no .item"):
        runner.process()


def _readouts():
    """(name, readout fn(r, M, a, **p), extra per-halo columns) of the
    port's table readouts: Baryonification2D (as it is, Rdelta-sampled,
    with a parameter axis), TabulatedProfile and ParamTabulatedProfile."""
    from test_torch_curves import TABLE
    cosmo = bf.cosmo.cosmology_from_dict(COSMO_DICT)
    s19 = torch_model()
    rdelta = torch_model()
    rdelta.Rdelta_sampling = True
    with np.load(TABLE, allow_pickle=True) as f:
        d = f["d"]
        ranges = [f[k] for k in ("z_range", "M_range", "r_range")]
    c_grid = np.array([2.0, 4.0, 7.0])
    pk = torch_model()
    pk._set_table(d[..., None] * (1.0 + 0.1 * c_grid), *ranges, ["conc"],
                  [c_grid], False)
    tab = convert.tabulated_from_jax(jax_tables()["log"], device="cpu")
    raw = bf.utils.ParamTabulatedProfile(None, cosmo,
                                         mass_def=bf.cosmo.MassDef200c)
    raw._set_axes(tab._axes, np.exp(tab.raw_input_3D),
                  np.exp(tab.raw_input_2D))
    conc = {"conc": np.linspace(2.5, 6.5, 6)}
    return [("s19", lambda r, M, a: s19.displacement(r, M, a), {}),
            ("s19-rdelta", lambda r, M, a: rdelta.displacement(r, M, a), {}),
            ("s19-p_key", lambda r, M, a, conc: pk.displacement(
                r, M, a, conc=conc), conc),
            ("tab-projected", lambda r, M, a: tab.projected(cosmo, r, M, a),
             {}),
            ("tab-real", lambda r, M, a: tab.real(cosmo, r, M, a), {}),
            ("raw-projected", lambda r, M, a: raw.projected(cosmo, r, M, a),
             {})]


def test_port_readouts_run_under_vmap():
    """The port's table readouts run under ops.direct.readout's
    torch.func.vmap, bitwise equal to one call a halo (NaN off the
    table), on rows of ragged length padded in their groups."""
    rng = np.random.default_rng(4)
    counts = np.array([3, 8, 5, 1, 8, 6])
    lay = direct.row_layout(counts)
    r = torch.as_tensor(rng.uniform(0.01, 8.0, lay.n_slots))
    M = torch.as_tensor(10 ** rng.uniform(13.0, 14.6, 6))
    a = torch.as_tensor(rng.uniform(0.48, 0.58, 6))
    for name, fn, extra in _readouts():
        cols = dict(M=M, a=a, **{k: torch.as_tensor(v)
                                 for k, v in extra.items()})
        got = direct.readout(fn, r, lay, cols, torch.float64)
        for i in range(6):
            sl = slice(int(lay.base[i]), int(lay.base[i] + counts[i]))
            one = fn(r[sl], **{k: c[i] for k, c in cols.items()})
            assert torch.equal(torch.nan_to_num(got[sl], nan=-1.0),
                               torch.nan_to_num(one.reshape(-1), nan=-1.0)), \
                name


def test_row_layout_groups_and_pads():
    """ops.direct.row_layout: widths 1, 2, 3, 4, 6, 8, 12, 16, ...; each
    halo's row in its width's group, halos in ascending index, a group cut
    at the slot budget, under a third of padding a row."""
    np.testing.assert_array_equal(
        direct.row_width([0, 1, 2, 3, 4, 5, 6, 7, 9, 13, 17, 25, 33]),
        [0, 1, 2, 3, 4, 6, 6, 8, 12, 16, 24, 32, 48])
    counts = np.array([5, 0, 3, 6, 40, 2, 5, 5, 33])
    lay = direct.row_layout(counts, budget=12)
    assert lay.base[1] == -1
    seen = []
    for h, K, s0 in lay.groups:
        assert (direct.row_width(counts[h]) == K).all()
        assert (np.diff(h) > 0).all() and h.size * K <= max(12, K)
        np.testing.assert_array_equal(lay.base[h], s0 + K * np.arange(h.size))
        seen += list(h)
    assert sorted(seen) == [i for i in range(9) if counts[i]]
    assert lay.n_slots == sum(h.size * K for h, K, _ in lay.groups)
    assert (direct.row_width(counts[counts > 0]) < 1.5 * counts[counts > 0]
            + 1).all()
    assert "padding" in lay.describe()


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_ring_dphi_is_one_division(dt):
    """Every plain version takes a ring's phi step from ``hpx.ring_dphi``:
    2 pi / nr as one float64 division rounded once to the dtype (as the
    kernels' ring_dphi and the JAX package's ``2 pi / nr``), for every ring
    length up to NSIDE 8192. torch's form for a Python number over a
    tensor, a reciprocal times the number, is not that division on some
    lengths, and a pixel's phi, j steps from 0, then moves by j ulps: for
    a disc far in phi from 0, r moves by that times D / a."""
    nr = torch.arange(4, 4 * 8192 + 1, 4, dtype=torch.int32)
    want = 2 * np.pi / nr.numpy().astype(np.float64)
    got = hpx.ring_dphi(nr, TDT[dt]).numpy()
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    if dt == "f64":
        assert (2 * np.pi / nr.double()).numpy().tolist() != want.tolist()
