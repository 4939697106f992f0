"""The grid runners of the torch port (plain versions of kernels K15 and
K16 on the CPU; BaryonifyGrid, PaintProfilesGrid and PaintProfilesAnisGrid
with device="cpu") against baryonforge_tpu.

Models: the Schneider19 displacement table of tools/_northstar_table.npz
(a Baryonification2D table, at z = 0.9) for BaryonifyGrid, and the
TabulatedProfile(DarkMatter(**bpar_S19, proj_cutoff=100)) of
tests/test_runners_extra.py:19-32 (at z = 0.2) for the paint runners, each
carried across with utils.convert. Tolerances:
  * float64: 1e-10 of the map's largest value (of the largest move for
    BaryonifyGrid);
  * float32: the JAX package's own bound between two float32 anisotropic
    paints (tests/test_runners_extra.py:250-261: rtol 2e-2, atol 2e-5 of
    the largest value);
  * mass: conserved to 1e-10 (tests/test_runners_extra.py:108).
Every JAX runner here runs with n_size_buckets=1: with more buckets its
compiled scan is keyed on the batch shapes and not on the cutout size, and
a later bucket can run an earlier bucket's smaller cutout (ROADMAP Queue
3). A port-only test shows that the port's n_size_buckets=4 is the sum of
its buckets, each with its own cutout.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Profiles as JProfiles           # noqa: E402
from baryonforge_tpu import utils as JUtils                 # noqa: E402
from baryonforge_tpu.ops import scatter as jscatter         # noqa: E402
from baryonforge_tpu.Profiles.BaryonCorrection import \
    Baryonification2D as JBaryonification2D                # noqa: E402
from baryonforge_tpu.Runners import Map2DRunner as JMap     # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import grid as tgrid             # noqa: E402
from baryonforge_torch.ops import scatter as tscatter       # noqa: E402
from baryonforge_torch.Runners import Map2DRunner as TMap   # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from defaults import COSMO, COSMO_DICT, bpar_S19            # noqa: E402
from test_runners_extra import _tab                         # noqa: E402
import os                                                   # noqa: E402

TABLE = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                     "_northstar_table.npz")
JDT = {"f32": jnp.float32, "f64": jnp.float64}
TDT = {"f32": torch.float32, "f64": torch.float64}


@pytest.fixture(scope="module")
def models():
    """(JAX, port) pairs: the DarkMatter table and the S19 displacement
    table."""
    jtab = _tab()
    jb = JBaryonification2D(JProfiles.DarkMatterOnly(**bpar_S19),
                            JProfiles.DarkMatterBaryon(**bpar_S19), COSMO,
                            epsilon_max=20)
    jb.load_table(TABLE)
    return {"dm": (jtab, convert.tabulated_from_jax(jtab, device="cpu")),
            "s19": (jb, convert.baryonification_from_jax(jb, device="cpu"))}


def grid_inputs(ndim, npix, L, n, z, seed, ell=False, mass=(13.5, 14.8)):
    """Catalog columns and map of a periodic grid (numpy), and the two
    packages' catalog and map objects."""
    rng = np.random.default_rng(seed)
    cols = dict(x=rng.uniform(0, L, n), y=rng.uniform(0, L, n),
                M=10 ** rng.uniform(*mass, n))
    if ndim == 3:
        cols["z"] = rng.uniform(0, L, n)
    if ell:
        cols.update(q_ell=rng.uniform(0.5, 0.9, n),
                    A_ell=rng.normal(size=(n, 2)))
    bins = (np.arange(npix) + 0.5) * (L / npix)
    m = rng.exponential(1.0, (npix,) * ndim)
    mk = [(JUtils.HaloNDCatalog, JUtils.GriddedMap),
          (bf.utils.HaloNDCatalog, bf.utils.GriddedMap)]
    return [(C(**cols, redshift=z, cosmo=COSMO_DICT),
             G(map=m, bins=bins, cosmo=COSMO_DICT, redshift=z))
            for C, G in mk]


# -- K16: the grid deposit ------------------------------------------------
@pytest.mark.parametrize("ndim,npix", [(2, 16), (3, 8)])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_deposit_plain_matches_jax(ndim, npix, dt):
    """deposit_2d/3d_plain against ops/scatter.deposit_2d/3d on positions
    across the periodic edges (and on the lattice: exact identity),
    float64 to 1e-12 of the largest value, float32 to 1e-5 of it (the
    2^d-term sums in another order)."""
    rng = np.random.default_rng(ndim)
    M = 500
    pos = rng.uniform(-npix, 2 * npix, (M, ndim)).astype(JDT[dt])
    pos[:20] = rng.integers(0, npix, (20, ndim))
    vals = rng.uniform(0.5, 2.0, M).astype(JDT[dt])
    jfn = jscatter.deposit_2d if ndim == 2 else jscatter.deposit_3d
    tfn = tscatter.deposit_2d_plain if ndim == 2 \
        else tscatter.deposit_3d_plain
    ref = np.asarray(jfn(jnp.zeros((npix,) * ndim, JDT[dt]),
                         jnp.asarray(pos), jnp.asarray(vals)))
    out = tfn(torch.zeros((npix,) * ndim, dtype=TDT[dt]),
              torch.as_tensor(pos), torch.as_tensor(vals)).numpy()
    assert out.dtype == ref.dtype
    rel = 1e-12 if dt == "f64" else 1e-5
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * ref.max())
    np.testing.assert_allclose(out.sum(), vals.sum(dtype=np.float64),
                               rtol=rel)


@pytest.mark.parametrize("ndim,npix", [(2, 24), (3, 10)])
def test_grid_deposit_matches_jax_regrid(ndim, npix):
    """grid_deposit (CPU: the plain version of K16) against the JAX
    runner's regrid (Map2DRunner.py:447-466: the lattice plus the finite
    offsets, then deposit_2d/3d), float32 offsets and a float64 map."""
    rng = np.random.default_rng(7)
    nflat = npix ** ndim
    po = rng.uniform(-3, 3, (nflat, ndim)).astype(np.float32)
    po[::13, 0] = np.nan
    orig = rng.exponential(1.0, nflat)
    ii = jnp.arange(npix)
    if ndim == 2:
        base = jnp.stack([jnp.repeat(ii, npix), jnp.tile(ii, npix)], axis=1)
        jfn = jscatter.deposit_2d
    else:
        base = jnp.stack([jnp.repeat(ii, npix * npix),
                          jnp.tile(jnp.repeat(ii, npix), npix),
                          jnp.tile(ii, npix * npix)], axis=1)
        jfn = jscatter.deposit_3d
    jpo = jnp.asarray(po)
    jpo = jnp.where(jnp.isfinite(jpo), jpo, 0.0).astype(jnp.float64)
    ref = np.asarray(jfn(jnp.zeros((npix,) * ndim), base + jpo,
                         jnp.asarray(orig))).reshape(-1)
    _build.reset_launches()
    out = tscatter.grid_deposit(torch.as_tensor(po.T.copy()),
                                torch.as_tensor(orig), npix, ndim).numpy()
    assert not _build.launches
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * ref.max())


# -- the runners ----------------------------------------------------------
RUNS = [("baryonify", 2, False), ("baryonify", 2, True),
        ("baryonify", 3, False), ("paint", 2, False), ("paint", 2, True),
        ("paint", 3, False), ("anis", 2, False), ("anis", 2, True)]


def _run(which, pkg, models, cat, gm, dt, **extra):
    """One runner of ``pkg`` ("jax" or "torch") on (cat, gm): its map."""
    jm = {k: v[0] for k, v in models.items()}
    tm = {k: v[1] for k, v in models.items()}
    m = jm if pkg == "jax" else tm
    if which == "baryonify":
        kw = dict(epsilon_max=20, model=m["s19"])
    elif which == "paint":
        kw = dict(epsilon_max=5, model=m["dm"])
    else:
        kw = dict(epsilon_max=5, model=m["dm"], Tracer_model=m["dm"],
                  Mtot_model=m["dm"], background_val=1.0,
                  global_tracer_fraction=0.1)
    kw.update(n_size_buckets=1, **extra)
    if pkg == "jax":
        cls = {"baryonify": JMap.BaryonifyGrid,
               "paint": JMap.PaintProfilesGrid,
               "anis": JMap.PaintProfilesAnisGrid}[which]
        return np.asarray(cls(cat, gm, dtype=JDT[dt], verbose=False,
                              **kw).process(), dtype=np.float64)
    cls = {"baryonify": bf.BaryonifyGrid, "paint": bf.PaintProfilesGrid,
           "anis": bf.PaintProfilesAnisGrid}[which]
    r = cls(cat, gm, dtype=TDT[dt], device="cpu", **kw)
    return r.process(), r


@pytest.mark.parametrize("which,ndim,ell", RUNS,
                         ids=[f"{w}-{d}d{'-ell' if e else ''}"
                              for w, d, e in RUNS])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_grid_runner_matches_jax(models, which, ndim, ell, dt):
    """Each grid runner on the CPU against the JAX runner: float64 to 1e-10
    of the largest value (move), float32 to the JAX package's bound;
    BaryonifyGrid conserves mass to 1e-10."""
    z = 0.9 if which == "baryonify" else 0.2
    npix, L = (64, 64.0) if ndim == 2 else (20, 40.0)
    (jcat, jgm), (tcat, tgm) = grid_inputs(ndim, npix, L, 12, z,
                                           seed=30 + ndim, ell=ell)
    ref = _run(which, "jax", models, jcat, jgm, dt, use_ellipticity=ell)
    _build.reset_launches()
    out, r = _run(which, "torch", models, tcat, tgm, dt, use_ellipticity=ell)
    assert not _build.launches         # CPU: the plain versions
    assert out.shape == tgm.map.shape and out.dtype == np.float64
    phases = {"baryonify": ("host_prep", "curves", "deposit", "regrid",
                            "download"),
              "paint": ("host_prep", "curves", "paint", "download"),
              "anis": ("canvas", "host_prep", "curves", "paint",
                       "download")}[which]
    assert tuple(r.timings) == phases
    if which == "baryonify":
        scale = np.abs(ref - tgm.map).max()
        np.testing.assert_allclose(out.sum(), tgm.map.sum(), rtol=1e-10)
    else:
        scale = np.abs(ref).max()
    assert scale > 0
    if dt == "f64":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10 * scale)
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-5 * scale)


@pytest.mark.parametrize("ndim", [2, 3])
def test_size_buckets_are_their_own_cutouts(models, ndim):
    """n_size_buckets=4 paints, per bucket, the cutout of that bucket's
    largest size: the map is the sum of four runs over the buckets' halos,
    each with its own cutout (float64, 1e-12 of the largest value); the
    JAX split (np.argsort, np.array_split) makes the buckets; and the
    one-bucket map differs at the cutout edges."""
    npix, L = (64, 64.0) if ndim == 2 else (20, 40.0)
    _, (tcat, tgm) = grid_inputs(ndim, npix, L, 24, 0.2, seed=9,
                                 mass=(13.0, 14.8))
    tab = models["dm"][1]
    kw = dict(epsilon_max=5, model=tab, dtype=torch.float64, device="cpu")
    r4 = bf.PaintProfilesGrid(tcat, tgm, n_size_buckets=4, **kw)
    full = r4.process()
    cosmo = bf.cosmo.cosmology_from_dict(r4.cosmo)
    _, a, M, R = r4._halo_data(cosmo)
    Nsize = r4._cutout_sizes(r4.epsilon_max * R / a)
    buckets = r4._buckets(Nsize)
    want = np.array_split(np.argsort(Nsize), 4)
    assert [list(b) for b, _ in buckets] == [list(w) for w in want]
    assert len({Ns for _, Ns in buckets}) > 1
    parts = np.zeros_like(full)
    for idx, Ns in buckets:
        sub = tcat[np.sort(idx)]
        part = bf.PaintProfilesGrid(sub, tgm, n_size_buckets=1,
                                    **kw).process()
        parts += part
    np.testing.assert_allclose(full, parts, rtol=0,
                               atol=1e-12 * np.abs(full).max())
    one = bf.PaintProfilesGrid(tcat, tgm, n_size_buckets=1, **kw).process()
    assert not np.allclose(one, full, rtol=0, atol=1e-12 * full.max())


def test_anis_curves_equal_the_table_readout(models):
    """The anisotropic grid paint reads its model and tracer as K1 curves:
    on every cell of the test's cutouts, in float64, the curve lookup over
    a equals the port's TabulatedProfile.projected (the JAX body's direct
    readout) to 1e-12 relative, with the same zeros."""
    _, (tcat, tgm) = grid_inputs(2, 64, 64.0, 12, 0.2, seed=32)
    tab = models["dm"][1]
    r = bf.PaintProfilesAnisGrid(tcat, tgm, epsilon_max=5, model=tab,
                                 Tracer_model=tab, Mtot_model=tab,
                                 background_val=1.0,
                                 global_tracer_fraction=0.1, device="cpu")
    cosmo = bf.cosmo.cosmology_from_dict(r.cosmo)
    cat, a, M, R = r._halo_data(cosmo)
    Nsize = r._cutout_sizes(r.epsilon_max * R / a)
    cen, d_off = r._positions(cat)
    curves, r0, dl = tab.with_dtype(torch.float64).halo_curves(
        M, np.full(M.shape, a), kind="projected")
    n_cells = 0
    for idx, Ns in r._buckets(Nsize):
        ix = torch.as_tensor(idx)
        _, _, rr = tgrid._geometry(tgm.Npix, Ns, tgm.res,
                                   torch.as_tensor(cen[idx]),
                                   torch.as_tensor(d_off[idx]), None)
        lerp = tab.curve_lookup(curves[ix], float(r0), float(dl), rr) / a
        for k, h in enumerate(idx):
            direct = tab.projected(None, rr[k], float(M[h]), a)
            direct = torch.where(torch.isfinite(direct), direct,
                                 torch.zeros_like(direct))
            assert torch.equal(direct == 0, lerp[k] == 0)
            torch.testing.assert_close(lerp[k], direct, rtol=1e-12, atol=0)
            n_cells += int((direct > 0).sum())
    assert n_cells > 1000


def test_baryonify_grid_mass_and_refusals(models, monkeypatch):
    """BaryonifyGrid conserves mass in float32 and float64 (1e-10 relative
    with the float64 regrid), raises ValueError for a halo more than a cell
    from its nearest grid centre (the JAX runner's assert), and
    RuntimeError when the regrid loses mass."""
    _, (tcat, tgm) = grid_inputs(2, 48, 48.0, 10, 0.9, seed=3)
    tb = models["s19"][1]
    for dt in (torch.float32, torch.float64):
        out = bf.BaryonifyGrid(tcat, tgm, epsilon_max=20, model=tb, dtype=dt,
                               device="cpu").process()
        np.testing.assert_allclose(out.sum(), tgm.map.sum(), rtol=1e-10)
        assert np.abs(out - tgm.map).max() > 0
    far = bf.utils.HaloNDCatalog(x=np.array([60.0]), y=np.array([5.0]),
                                 M=np.array([1e14]), redshift=0.9,
                                 cosmo=COSMO_DICT)
    with pytest.raises(ValueError, match="offsets larger"):
        bf.BaryonifyGrid(far, tgm, epsilon_max=20, model=tb,
                         device="cpu").process()
    monkeypatch.setattr(TMap, "grid_deposit",
                        lambda po, orig, npix, ndim: orig * 0.5)
    with pytest.raises(RuntimeError, match="regridding"):
        bf.BaryonifyGrid(tcat, tgm, epsilon_max=20, model=tb,
                         device="cpu").process()


def test_grid_runners_refuse(models):
    """No halo_curves, no CUDA by default, missing ellipticity columns, 3D
    ellipticity and a 3D anisotropic paint all raise."""
    _, (tcat, tgm) = grid_inputs(2, 16, 16.0, 4, 0.2, seed=1)
    _, (tcat3, tgm3) = grid_inputs(3, 8, 8.0, 4, 0.2, seed=1, ell=True)
    tab = models["dm"][1]
    with pytest.raises(NotImplementedError, match="halo_curves"):
        bf.PaintProfilesGrid(tcat, tgm, epsilon_max=5, model=object(),
                             device="cpu").process()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bf.BaryonifyGrid(tcat, tgm, epsilon_max=5, model=tab)
    with pytest.raises(ValueError, match="q_ell"):
        bf.PaintProfilesGrid(tcat, tgm, epsilon_max=5, model=tab,
                             use_ellipticity=True, device="cpu")
    with pytest.raises(NotImplementedError, match="2D-only"):
        bf.PaintProfilesGrid(tcat3, tgm3, epsilon_max=5, model=tab,
                             use_ellipticity=True, device="cpu")
    with pytest.raises(ValueError, match="2D-only"):
        bf.PaintProfilesAnisGrid(tcat3, tgm3, epsilon_max=5, model=tab,
                                 Tracer_model=tab, Mtot_model=tab,
                                 background_val=1.0,
                                 global_tracer_fraction=0.1, device="cpu")


def test_grid_helpers_match_jax():
    """build_Rmat, coord_array, pick_indices, the per-halo shear matrices
    and the nearest grid centres against the JAX runner's."""
    jr = JMap.DefaultRunnerGrid.__new__(JMap.DefaultRunnerGrid)
    tr = TMap.DefaultRunnerGrid.__new__(TMap.DefaultRunnerGrid)
    rng = np.random.default_rng(2)
    A = rng.normal(size=(20, 2))
    q = rng.uniform(0.3, 1.0, 20)
    q[0] = 1.0
    q[1] = 1 - 5e-5                     # the small-eta series
    mats = TMap._shear_matrix(A, q)
    for i in range(20):
        np.testing.assert_allclose(
            mats[i], np.asarray(JMap._shear_matrix(jnp.asarray(A[i]),
                                                   q[i])),
            rtol=1e-14, atol=1e-15)
        np.testing.assert_allclose(tr.build_Rmat(A[i], q[i]),
                                   jr.build_Rmat(A[i], q[i]), rtol=1e-14,
                                   atol=1e-15)
    with pytest.raises(NotImplementedError):
        tr.build_Rmat(np.array([1.0, 0.0, 0.0]), 0.7)
    with pytest.raises(ValueError):
        tr.build_Rmat(np.array([1.0]), 0.7)
    # the nearest grid centre (the JAX runner's argmin over the bins), at
    # random positions, on the centres and on the midpoints (ties)
    for npix, L in ((1, 1.0), (7, 7.0), (64, 32.0)):
        bins = (np.arange(npix) + 0.5) * (L / npix)
        pos = np.concatenate([rng.uniform(-3, L + 3, (500, 2)),
                              np.repeat(bins[:, None], 2, 1),
                              np.repeat(((bins[:-1] + bins[1:]) / 2)[:, None],
                                        2, 1)])
        np.testing.assert_array_equal(
            TMap._nearest_bins(bins, pos),
            np.argmin(np.abs(bins[None, None, :] - pos[:, :, None]),
                      axis=2))
    np.testing.assert_array_equal(tr.pick_indices(1, 3, 10),
                                  jr.pick_indices(1, 3, 10))
    x = np.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(tr.coord_array(x, -x),
                                  jr.coord_array(x, -x))
