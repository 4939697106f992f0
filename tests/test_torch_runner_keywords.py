"""The JAX runners' keywords and ``invalidate()`` in the torch port's
runners, and example 09's per-halo-property flow through the port, on the
CPU.

Every shell and grid runner takes the JAX runner's ``halo_batch``,
``pixel_budget`` and ``transfer`` (and the shells ``n_size_buckets``),
which tune its static-shape batching and tunnel download and do nothing
here: each runner built with them gives, bit for bit, the map it gives
without them. The shells' ``invalidate()`` drops the data-derived state,
so that an Mtot model whose table was edited in place takes effect in the
anisotropic shell, as in a fresh runner, while the per-NSIDE geometry is
kept.

Example 09 (examples/09_secondary_properties.py: a ParamTabulatedProfile
of DarkMatter over one key, epsilon, and a PaintProfilesShell of 300 halos
with their own epsilon at NSIDE 64, halo_batch=64): the JAX table carried
across by ``utils.convert`` and painted by the port on the CPU (the
example's float32) against the JAX runner's map, to the JAX package's
bound between two float32 paints (tests/test_tiled_deposit.py:113).
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

from baryonforge_tpu import Profiles as JProfiles           # noqa: E402
from baryonforge_tpu import Runners as JRunners             # noqa: E402
from baryonforge_tpu import utils as JUtils                 # noqa: E402
from baryonforge_tpu.cosmo import core as jcore             # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from test_torch_curves import BPAR, COSMO_DICT              # noqa: E402

TABLE = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                     "_northstar_table.npz")
SHELL_KW = dict(halo_batch=64, n_size_buckets=2, pixel_budget=1000,
                transfer="sync")
GRID_KW = dict(halo_batch=8, pixel_budget=1000, transfer="sync")
# the paints' epsilon_max on the shell: discs of a few pixels at NSIDE 64
EPS = 40
NSIDE = 64


@pytest.fixture(scope="module")
def models():
    """The S19 displacement table of tools/_northstar_table.npz (z 0.7 -
    1.1) and a small DarkMatter TabulatedProfile built on the CPU."""
    cosmo = bf.cosmo.cosmology_from_dict(COSMO_DICT)
    s19 = bf.Baryonification2D(None, None, cosmo,
                               epsilon_max=20).load_table(TABLE)
    dm = bf.utils.TabulatedProfile(
        bf.Profiles.DarkMatter(**BPAR, proj_cutoff=100), cosmo, device="cpu")
    dm.setup_interpolator(z_min=0.5, z_max=1.2, N_samples_z=3, M_min=5e12,
                          M_max=3e15, N_samples_Mass=5, R_min=1e-3,
                          R_max=60, N_samples_R=32, verbose=False)
    return s19, dm


def shell_inputs(n=40, seed=2):
    rng = np.random.default_rng(seed)
    cat = bf.utils.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
        M=10 ** rng.uniform(13.5, 14.8, n), z=rng.uniform(0.8, 1.0, n),
        cosmo=COSMO_DICT)
    shell = bf.utils.LightconeShell(
        map=rng.exponential(1.0, 12 * NSIDE ** 2), cosmo=COSMO_DICT,
        redshift=0.9)
    return cat, shell


def grid_inputs(ndim, npix, n=12, L=64.0, seed=3):
    rng = np.random.default_rng(seed)
    cols = {k: rng.uniform(0, L, n) for k in "xyz"[:ndim]}
    cat = bf.utils.HaloNDCatalog(**cols, M=10 ** rng.uniform(13.5, 14.8, n),
                                 redshift=0.9, cosmo=COSMO_DICT)
    gm = bf.utils.GriddedMap(map=rng.exponential(1.0, (npix,) * ndim),
                             bins=(np.arange(npix) + 0.5) * (L / npix),
                             cosmo=COSMO_DICT, redshift=0.9)
    return cat, gm


def anis_kw(dm):
    return dict(Tracer_model=dm, Mtot_model=dm, background_val=1.0,
                global_tracer_fraction=0.1)


def runner_cases(models):
    """(label, make(**jax keywords), the JAX keywords, the input map) for
    each runner."""
    s19, dm = models
    cat, shell = shell_inputs()
    c2, g2 = grid_inputs(2, 48)
    c3, g3 = grid_inputs(3, 16)
    cpu = dict(device="cpu")
    return [
        ("BaryonifyShell tiled", lambda **k: bf.BaryonifyShell(
            cat, shell, epsilon_max=20, model=s19, **cpu, **k), SHELL_KW,
         shell.map),
        ("BaryonifyShell scatter", lambda **k: bf.BaryonifyShell(
            cat, shell, epsilon_max=20, model=s19, deposit="scatter", **cpu,
            **k), SHELL_KW, shell.map),
        ("PaintProfilesShell", lambda **k: bf.PaintProfilesShell(
            cat, shell, epsilon_max=EPS, model=dm, **cpu, **k), SHELL_KW,
         0.0),
        ("PaintProfilesAnisShell", lambda **k: bf.PaintProfilesAnisShell(
            cat, shell, EPS, dm, **anis_kw(dm), **cpu, **k), SHELL_KW,
         shell.map),
        ("BaryonifyGrid 2D", lambda **k: bf.BaryonifyGrid(
            c2, g2, epsilon_max=10, model=s19, **cpu, **k), GRID_KW, g2.map),
        ("PaintProfilesGrid 3D", lambda **k: bf.PaintProfilesGrid(
            c3, g3, epsilon_max=5, model=dm, **cpu, **k), GRID_KW, 0.0),
        ("PaintProfilesAnisGrid 2D", lambda **k: bf.PaintProfilesAnisGrid(
            c2, g2, 5, dm, **anis_kw(dm), **cpu, **k), GRID_KW, g2.map),
    ]


@pytest.mark.parametrize("case", range(7))
def test_jax_keywords_change_no_map(models, case):
    """Each runner with the JAX tuning keywords keeps them as attributes
    and gives its map without them, bit for bit."""
    label, make, kw, orig = runner_cases(models)[case]
    with_kw = make(**kw)
    for k, v in kw.items():
        assert getattr(with_kw, k) == v, (label, k)
    got = with_kw.process()
    want = make().process()
    assert np.isfinite(want).all(), label
    assert (np.abs(want - orig) > 0).sum() > 100, label
    assert np.array_equal(got, want), label


def test_jax_keyword_defaults():
    """The JAX runners' defaults (shell: 4096, 4, 4e6, "auto"; grid: 256,
    8e6, "auto")."""
    import inspect
    shell = inspect.signature(bf.Runners.HealpixRunner.DefaultRunner)
    grid = inspect.signature(bf.Runners.Map2DRunner.DefaultRunnerGrid)
    assert {k: shell.parameters[k].default for k in SHELL_KW} == dict(
        halo_batch=4096, n_size_buckets=4, pixel_budget=4_000_000,
        transfer="auto")
    assert {k: grid.parameters[k].default for k in GRID_KW} == dict(
        halo_batch=256, pixel_budget=8_000_000, transfer="auto")


def test_invalidate_sees_an_edited_mtot_table(models):
    """A float32 anisotropic shell keeps its models' float32 casts; after
    the Mtot model's table is edited in place (its projected profile
    doubled), invalidate() drops them and the nested Mtot runner, and the
    next call equals a fresh runner's, while the per-NSIDE geometry stays
    cached for the process: the same entries, none filled again."""
    _, dm = models
    cosmo = bf.cosmo.cosmology_from_dict(COSMO_DICT)
    mtot = bf.utils.TabulatedProfile(
        bf.Profiles.DarkMatter(**BPAR, proj_cutoff=100), cosmo, device="cpu")
    mtot.raw_input_3D = dm.raw_input_3D.copy()
    mtot.raw_input_2D = dm.raw_input_2D.copy()
    for k in ("z", "M", "r"):
        setattr(mtot, f"raw_input_{k}_range",
                getattr(dm, f"raw_input_{k}_range"))
    mtot._set_tables()
    cat, shell = shell_inputs()
    kw = dict(Tracer_model=dm, Mtot_model=mtot, background_val=1.0,
              global_tracer_fraction=0.1, dtype=torch.float32, device="cpu")
    runner = bf.PaintProfilesAnisShell(cat, shell, EPS, dm, **kw)
    before = runner.process()
    geometry = {k: dict(g) for k, g in bf.ops.geometry._groups.items()}
    assert geometry and runner._mtot is not None
    mtot._tab2D += math.log(2.0)            # in place: the same tensor
    runner.invalidate()
    assert "_mtot" not in vars(runner) and "_casts" not in vars(mtot)
    assert {k: dict(g) for k, g in bf.ops.geometry._groups.items()} \
        == geometry
    after = runner.process()
    assert runner.timings.get("count.cache_fills", 0) == 0
    fresh = bf.PaintProfilesAnisShell(cat, shell, EPS, dm, **kw).process()
    assert np.array_equal(after, fresh)
    assert not np.allclose(after, before)
    for r in (bf.BaryonifyShell(cat, shell, epsilon_max=20, model=models[0],
                                device="cpu"),
              bf.PaintProfilesShell(cat, shell, epsilon_max=EPS, model=dm,
                                    device="cpu")):
        r.invalidate()


def test_example_09_flow_matches_jax():
    """examples/09_secondary_properties.py through the port: the JAX
    ParamTabulatedProfile (DarkMatter over epsilon 2, 4, 6) carried across
    by utils.convert, 300 halos with their own epsilon at NSIDE 64, the
    float32 paint on the CPU against the JAX runner's, to the JAX bound
    between two float32 paints; the port's curves read the epsilon
    column."""
    h = 0.7
    bpar = dict(BPAR, M_c=1e14 / h, M1=2.5e11 / h)
    cosmo_dict = dict(COSMO_DICT)
    jt = JUtils.ParamTabulatedProfile(
        JProfiles.DarkMatter(**bpar, proj_cutoff=100),
        jcore.cosmology_from_dict(cosmo_dict))
    jt.setup_interpolator(z_min=0.1, z_max=0.5, N_samples_z=3, M_min=1e13,
                          M_max=1e15, N_samples_Mass=6, R_min=1e-3,
                          R_max=60, N_samples_R=48,
                          other_params={"epsilon": np.array([2.0, 4.0,
                                                             6.0])},
                          verbose=False)
    tt = convert.tabulated_from_jax(jt, device="cpu")
    assert tt.p_keys == ["epsilon"]
    n, nside = 300, 64
    rng = np.random.default_rng(11)
    cols = dict(ra=rng.uniform(0, 360, n),
                dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
                M=10 ** rng.uniform(13.5, 14.5, n),
                z=rng.uniform(0.15, 0.45, n),
                epsilon=rng.uniform(2.0, 6.0, n))
    jout = np.asarray(JRunners.PaintProfilesShell(
        JUtils.HaloLightConeCatalog(**cols, cosmo=cosmo_dict),
        JUtils.LightconeShell(map=np.zeros(12 * nside ** 2),
                              cosmo=cosmo_dict),
        epsilon_max=5, model=jt, halo_batch=64, verbose=False).process(),
        dtype=np.float64)
    tout = bf.PaintProfilesShell(
        bf.utils.HaloLightConeCatalog(**cols, cosmo=cosmo_dict),
        bf.utils.LightconeShell(map=np.zeros(12 * nside ** 2),
                                cosmo=cosmo_dict),
        epsilon_max=5, model=tt, halo_batch=64, device="cpu").process()
    assert jout.max() > 0 and (jout > 0).sum() > 50
    np.testing.assert_allclose(tout, jout, atol=2e-3 * np.abs(jout).max(),
                               rtol=2e-3)
    flat = bf.PaintProfilesShell(
        bf.utils.HaloLightConeCatalog(**dict(cols, epsilon=np.full(n, 4.0)),
                                      cosmo=cosmo_dict),
        bf.utils.LightconeShell(map=np.zeros(12 * nside ** 2),
                                cosmo=cosmo_dict),
        epsilon_max=5, model=tt, device="cpu").process()
    assert not np.allclose(flat, tout)
