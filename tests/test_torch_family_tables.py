"""The displacement tables of the Arico20, Mead20 and Schneider25 families
in the torch port against baryonforge_tpu's builds, and a small 3D
BaryonifyGrid run on the Arico20 table against the JAX runner on the JAX
table (the plain versions of kernels K1, K8, K9, K15 and K16 on the CPU),
and baryonification_from_jax of each family's JAX model.

  * Arico20: Baryonification3D(DarkMatterOnly, DarkMatterBaryon) of
    tests/defaults.py's bpar_A20, 2 z x 4 M x 16 r around z 0.2;
  * Mead20: Baryonification2D(DarkMatterOnlywithLSS,
    DarkMatterBaryonwithLSS) of Tagn2pars(7.8), proj_cutoff=100, on
    chip_smoke.py's small shell grid (2 z x 4 M x 16 r, z 0.7-1.1);
  * Schneider25: Baryonification2D(DarkMatterOnly, DarkMatterBaryon) of
    bpar_S25, proj_cutoff=100, on the same grid.
The collisionless matter of Arico20 and Schneider25 runs at r_steps=500
in both packages (their default of 5000 costs the JAX side ~30 s).

Tolerances: tables 1e-9 of the largest |d| (tests/test_torch_table_build
.py); the grid run 1e-10 of the largest move, mass to 1e-10
(tests/test_torch_grid.py).

One reference-side effect shows here. The Arico20 collisionless matter
relaxes on a log grid from r_min to each halo's R, built as exp(ln r_min
+ (ln R - ln r_min) t); its last point lands an ulp below, on or above R
as the rounding of exp and log goes (about half of all halos lie above).
The truncations r <= R (DM, re-accreted gas) and r < R (bound gas) then
keep or drop the halo's boundary density, and the relaxation, normalised
at that point, moves the whole halo's profile by ~0.3% (d by up to ~7% of
the largest |d|). The JAX package's jitted table build and its eager
profile evaluation round it differently for some halos, and so may the
port. A table row that differs from the JAX build by more than 1e-9 must
therefore equal, to 1e-9, the port's row built with that halo's last grid
point set an ulp below, exactly on or an ulp above R; the test names such
rows.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import cosmo as jc                     # noqa: E402
from baryonforge_tpu import utils as JUtils                 # noqa: E402
from baryonforge_tpu.Profiles import Arico20 as JA          # noqa: E402
from baryonforge_tpu.Profiles import Mead20 as JM           # noqa: E402
from baryonforge_tpu.Profiles import Schneider25 as JS      # noqa: E402
from baryonforge_tpu.Profiles.BaryonCorrection import \
    Baryonification2D as JB2, Baryonification3D as JB3      # noqa: E402
from baryonforge_tpu.Runners import Map2DRunner as JMap     # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.Profiles import Arico20 as TA        # noqa: E402
from baryonforge_torch.Profiles import Base as TBase        # noqa: E402
from baryonforge_torch.Profiles import Mead20 as TM         # noqa: E402
from baryonforge_torch.Profiles import Schneider25 as TS    # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from defaults import COSMO_DICT, bpar_A20, bpar_S25         # noqa: E402

TOL = 1e-9
JCOSMO = jc.cosmology_from_dict(COSMO_DICT)
TCOSMO = bf.cosmo.cosmology_from_dict(COSMO_DICT)
A20_GRID = dict(z_min=0.1, z_max=0.3, N_samples_z=2, M_min=1e13, M_max=3e15,
                N_samples_Mass=4, R_min=1e-3, R_max=50, N_samples_R=16,
                verbose=False)
SHELL_GRID = dict(z_min=0.7, z_max=1.1, N_samples_z=2, M_min=5e12,
                  M_max=2e15, N_samples_Mass=4, R_min=1e-3, R_max=60,
                  N_samples_R=16, verbose=False)


def a20_models(pkg, cls):
    P = dict(bpar_A20, proj_cutoff=100, r_steps=500)
    return cls(pkg.DarkMatterOnly(**P), pkg.DarkMatterBaryon(**P))


def m20_models(pkg, cls):
    P = dict(pkg.Tagn2pars(7.8), proj_cutoff=100)
    return cls(pkg.DarkMatterOnlywithLSS(**P),
               pkg.DarkMatterBaryonwithLSS(**P))


def s25_models(pkg, cls):
    P = dict(bpar_S25, proj_cutoff=100)
    return cls(pkg.DarkMatterOnly(**P),
               pkg.DarkMatterBaryon(**P, collisionlessmatter=pkg
                                    .CollisionlessMatter(**P, r_steps=500)))


FAMILIES = {"Arico20": (a20_models, JA, TA, JB3, bf.Baryonification3D,
                        A20_GRID),
            "Mead20": (m20_models, JM, TM, JB2, bf.Baryonification2D,
                       SHELL_GRID),
            "Schneider25": (s25_models, JS, TS, JB2, bf.Baryonification2D,
                            SHELL_GRID)}


def build(family, pkg):
    """The family's table built by ``pkg`` ("jax" or "torch", on the
    CPU)."""
    models, jmod, tmod, jcls, tcls, grid = FAMILIES[family]
    if pkg == "jax":
        return models(jmod, lambda o, b: jcls(o, b, JCOSMO, epsilon_max=20)
                      ).setup_interpolator(**grid)
    return models(tmod, lambda o, b: tcls(o, b, TCOSMO, epsilon_max=20,
                                          device="cpu")
                  ).setup_interpolator(**grid)


def last_point(side):
    """Arico20's per-halo grid with each halo's last point an ulp below R,
    exactly on it or an ulp above."""
    def grid(r_min, R, steps):
        g = TBase._host_per_halo_loggrid(r_min, R, steps)
        g[:, -1] = {"below": torch.nextafter(R, torch.zeros_like(R)),
                    "on": R,
                    "above": torch.nextafter(R, torch.full_like(R, math.inf))
                    }[side]
        return g
    return grid


@pytest.fixture(scope="module")
def tables():
    """{family: (JAX model, port model)}, the port's built with no
    launch."""
    out = {}
    for family in FAMILIES:
        _build.reset_launches()
        tm = build(family, "torch")
        assert not _build.launches                # CPU: the plain versions
        out[family] = (build(family, "jax"), tm)
    return out


def flipped_rows(family, jm, tm):
    """The (z, M) rows of the port's table off the JAX build's by more than
    TOL of its largest |d|, each checked against the port's rows with the
    Arico20 per-halo grids' last point moved to each side of R."""
    dj, dt = jm.raw_input_d, tm.raw_input_d
    scale = np.abs(dj).max()
    assert dt.shape == dj.shape and scale > 0
    off = np.argwhere(np.abs(dt - dj).max(-1) > TOL * scale)
    if not off.size:
        return []
    assert family == "Arico20", (
        f"{family} table off the JAX build at (z, M) rows {off.tolist()}")
    mp = pytest.MonkeyPatch()
    try:
        variants = []
        for side in ("below", "on", "above"):
            mp.setattr(TA, "_host_per_halo_loggrid", last_point(side))
            variants.append(build(family, "torch").raw_input_d)
    finally:
        mp.undo()
    rows = []
    for iz, iM in off:
        err = [np.abs(v[iz, iM] - dj[iz, iM]).max() for v in variants]
        assert min(err) <= TOL * scale, (
            f"Arico20 row (z, M) = ({iz}, {iM}) off by {min(err):.3e} "
            f"(max |d| {scale:.3e}) with its last grid point on any side "
            "of R")
        rows.append((int(iz), int(iM), int(np.argmin(err))))
    return rows


@pytest.mark.parametrize("family", list(FAMILIES))
def test_table_matches_jax(tables, family):
    jm, tm = tables[family]
    rows = flipped_rows(family, jm, tm)
    print(f"{family}: rows matching the JAX build with the halo's last grid"
          f" point moved across R (z, M, side 0-2): {rows}")
    for k in ("z_range", "M_range", "r_range"):
        np.testing.assert_array_equal(getattr(tm, f"raw_input_{k}"),
                                      getattr(jm, f"raw_input_{k}"))
    assert np.isfinite(tm.raw_input_d).all()


def test_a20_grid_run_matches_jax(tables):
    """BaryonifyGrid 3D (32^3 cells of a 32 Mpc box, 20 halos at z 0.2,
    epsilon_max 20, one size bucket), float64: the port from its table,
    with any row that flipped (test_table_matches_jax) taken from the
    build that matches the JAX row, against the JAX runner from the JAX
    table."""
    jm, tm = tables["Arico20"]
    d = tm.raw_input_d.copy()
    rows = flipped_rows("Arico20", jm, tm)
    if rows:
        mp = pytest.MonkeyPatch()
        try:
            for iz, iM, side in rows:
                mp.setattr(TA, "_host_per_halo_loggrid", last_point(
                    ("below", "on", "above")[side]))
                d[iz, iM] = build("Arico20", "torch").raw_input_d[iz, iM]
        finally:
            mp.undo()
    tm = bf.Baryonification3D(None, None, TCOSMO, epsilon_max=20,
                              device="cpu")._set_table(
        d, jm.raw_input_z_range, jm.raw_input_M_range, jm.raw_input_r_range,
        [], [], False)
    rng = np.random.default_rng(4)
    n, L, npix = 20, 32.0, 32
    cols = dict(x=rng.uniform(0, L, n), y=rng.uniform(0, L, n),
                z=rng.uniform(0, L, n), M=10 ** rng.uniform(13.5, 14.8, n))
    m = rng.exponential(1.0, (npix,) * 3)
    bins = (np.arange(npix) + 0.5) * (L / npix)
    kw = dict(epsilon_max=20, n_size_buckets=1)
    ref = np.asarray(JMap.BaryonifyGrid(
        JUtils.HaloNDCatalog(**cols, redshift=0.2, cosmo=COSMO_DICT),
        JUtils.GriddedMap(map=m, bins=bins, cosmo=COSMO_DICT, redshift=0.2),
        model=jm, dtype=jnp.float64, verbose=False, **kw).process(),
        dtype=np.float64)
    _build.reset_launches()
    out = bf.BaryonifyGrid(
        bf.utils.HaloNDCatalog(**cols, redshift=0.2, cosmo=COSMO_DICT),
        bf.utils.GriddedMap(map=m, bins=bins, cosmo=COSMO_DICT,
                            redshift=0.2),
        model=tm, dtype=torch.float64, device="cpu", **kw).process()
    assert not _build.launches
    scale = np.abs(ref - m).max()
    assert scale > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(out.sum(), m.sum(), rtol=1e-10)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_baryonification_from_jax(tables, family):
    """A JAX displacement model of each family converts with its table
    and its profiles, as the port's classes."""
    jm = tables[family][0]
    tm = convert.baryonification_from_jax(jm, device="cpu")
    tmod = FAMILIES[family][2]
    assert type(tm) is FAMILIES[family][4]
    assert type(tm.DMB) is getattr(tmod, type(jm.DMB).__name__)
    assert type(tm.DMO) is getattr(tmod, type(jm.DMO).__name__)
    np.testing.assert_array_equal(tm.raw_input_d, jm.raw_input_d)
    np.testing.assert_array_equal(tm.raw_input_M_range,
                                  jm.raw_input_M_range)
