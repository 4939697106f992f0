"""The port's halo meshes and parallel front-ends (parallel/mesh.py) on the
CPU: tests/test_multichip.py:35-131 and tests/test_runners_extra.py:
111-122 with ``halo_mesh(8, device="cpu")`` (eight shards of the CPU, as
the JAX tests' virtual 8-CPU mesh).

Against the JAX package: the sharded scatter and tiled shells and the
sharded BaryonifyGrid and PaintProfilesGrid (2D) against the JAX runners
on ``baryonforge_tpu.parallel.halo_mesh(8)``, the models carried across
with utils.convert, in float64 to the port-vs-JAX runner tests' bounds
(1e-9 of the largest pixel change on the shell, 1e-10 on the grids).

Against the port without a mesh, to the JAX tests' tolerances: the
scatter shell at rtol 1e-12, the tiled and stencil shells within 1e-4 of
the largest move, mass conserved to 1e-8, the anisotropic shell at 1e-10,
SimpleParallel equal to a sequential loop at 1e-12, SplitJoinParallel's
paints at rtol 1e-12 / atol 1e-15; and the grid runners (float32 offsets
within 1e-5 of the largest move, float64 paints at 1e-12) and the snapshot
(positions to 2e-5, tests/test_snapshot.py:71-88) with a mesh against
none."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch import Profiles as TP                # noqa: E402
from baryonforge_torch import parallel                      # noqa: E402
from baryonforge_torch import utils as TU                   # noqa: E402
from baryonforge_torch.Profiles.BaryonCorrection import \
    Baryonification3D                                      # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402
import jax.numpy as jnp                                     # noqa: E402
from baryonforge_tpu import Profiles as JP                  # noqa: E402
from baryonforge_tpu import cosmo as jcosmo                 # noqa: E402
from baryonforge_tpu.Profiles.BaryonCorrection import \
    Baryonification3D as JBaryonification3D               # noqa: E402
from baryonforge_tpu import parallel as jparallel           # noqa: E402
from baryonforge_tpu import utils as JU                     # noqa: E402
from baryonforge_tpu import Runners as JRunners             # noqa: E402
from baryonforge_tpu.Runners import Map2DRunner as JMap     # noqa: E402

from test_torch_curves import BPAR, COSMO_DICT              # noqa: E402

COSMO = bf.cosmo.cosmology_from_dict(COSMO_DICT)
NSIDE = 32
NPIX = 12 * NSIDE * NSIDE
MESH = parallel.halo_mesh(8, device="cpu")


def _cat(rng, n=48):
    return TU.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
        M=10 ** rng.uniform(13.5, 15.0, n), z=rng.uniform(0.1, 0.4, n),
        cosmo=COSMO_DICT)


@pytest.fixture(scope="module")
def models():
    model = Baryonification3D(TP.DarkMatter(**BPAR),
                              TP.DarkMatter(**{**BPAR, "epsilon": 2.0}),
                              COSMO, epsilon_max=20, device="cpu")
    model.setup_interpolator(z_min=0.05, z_max=0.6, N_samples_z=3,
                             M_min=1e13, M_max=3e15, N_samples_Mass=5,
                             R_min=1e-3, R_max=50, N_samples_R=32,
                             verbose=False)
    tab = TU.TabulatedProfile(TP.DarkMatter(**BPAR, proj_cutoff=100), COSMO,
                              device="cpu")
    tab.setup_interpolator(z_min=0.05, z_max=0.6, N_samples_z=3,
                           M_min=1e13, M_max=3e15, N_samples_Mass=5,
                           R_min=1e-3, R_max=60, N_samples_R=32,
                           verbose=False)
    return model, tab


def test_halo_mesh_and_refusals(models):
    assert parallel.halo_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert parallel.halo_mesh(device="cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            parallel.halo_mesh()
    with pytest.raises(ValueError):
        parallel.halo_mesh(0, device="cpu")
    model, tab = models
    rng = np.random.default_rng(3)
    cat = _cat(rng, 4)
    shell = TU.LightconeShell(map=np.ones(NPIX), cosmo=COSMO_DICT)
    for bad, err in ((object(), TypeError), ("cpu", TypeError),
                     ([], ValueError), (["meta"], ValueError)):
        with pytest.raises(err):
            bf.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                              mesh=bad, device="cpu")
    r = bf.PaintProfilesShell(cat, shell, epsilon_max=5, model=tab,
                              device="cpu")
    r.mesh = object()               # as SplitJoinParallel sets it
    with pytest.raises(TypeError):
        r.process()


@pytest.mark.parametrize("kw", [dict(deposit="scatter"), dict(),
                                dict(regrid="stencil")],
                         ids=["scatter", "tiled", "stencil"])
def test_sharded_shell_matches_single(models, kw):
    """test_multichip.py:35-72, 114-131: the scatter shell to rtol 1e-12,
    the tiled engine (and its forced stencil) within 1e-4 of the largest
    move; mass to 1e-8."""
    model, _ = models
    rng = np.random.default_rng(21)
    cat = _cat(rng)
    raw = rng.exponential(1.0, NPIX)
    shell = TU.LightconeShell(map=raw, cosmo=COSMO_DICT)
    single = bf.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                               device="cpu", **kw).process()
    runner = bf.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                               device="cpu", mesh=MESH, **kw)
    sharded = runner.process()
    assert np.abs(single - raw).max() > 0
    if kw.get("deposit") == "scatter":
        np.testing.assert_allclose(sharded, single, rtol=1e-12, atol=1e-12)
    else:
        scale = np.abs(single - raw).max()
        np.testing.assert_allclose(sharded, single, atol=1e-4 * scale)
    np.testing.assert_allclose(sharded.sum(), raw.sum(), rtol=1e-8)
    assert "deposit" in runner.timings and "regrid" in runner.timings


# -- the port's mesh against the JAX package's ----------------------------
MESH_CASES = ["shell-scatter", "shell-tiled", "grid-baryonify2d",
              "grid-paint2d"]


@pytest.fixture(scope="module")
def jax_pairs():
    """(JAX, port) model pairs, the port's carried across with
    utils.convert: the DarkMatter Baryonification3D of
    tests/test_multichip.py:25-33 (z 0.05-0.6), the S19 displacement table
    of tools/_northstar_table.npz (z 0.75-1.05) and the DarkMatter
    TabulatedProfile of tests/test_runners_extra.py:19-32 (z 0.05-0.6)."""
    from test_torch_curves import jax_model
    from test_runners_extra import _tab
    jd = JBaryonification3D(JP.DarkMatter(**BPAR),
                            JP.DarkMatter(**{**BPAR, "epsilon": 2.0}),
                            jcosmo.cosmology_from_dict(COSMO_DICT),
                            epsilon_max=20)
    jd.setup_interpolator(z_min=0.05, z_max=0.6, N_samples_z=3,
                          M_min=1e13, M_max=3e15, N_samples_Mass=5,
                          R_min=1e-3, R_max=50, N_samples_R=32,
                          verbose=False)
    jb, jtab = jax_model(), _tab()
    return {"dm3d": (jd, convert.baryonification_from_jax(jd, device="cpu")),
            "s19": (jb, convert.baryonification_from_jax(jb, device="cpu")),
            "dm": (jtab, convert.tabulated_from_jax(jtab, device="cpu"))}


def _shell_pair(rng, n=48):
    """The two packages' catalog and shell at NSIDE 32, the catalog of
    test_multichip.py:18-24 at z 0.1-0.3 (an eighth of its discs take the
    tiles, the rest the disc deposit) and |dec| <= 60 deg, so that every
    disc is in the JAX runner's equatorial class and, with
    n_size_buckets=1, in one bucket (its compiled deposit is keyed on the
    batch shapes alone; ROADMAP Queue 3)."""
    cols = dict(ra=rng.uniform(0, 360, n),
                dec=np.degrees(np.arcsin(rng.uniform(-0.86, 0.86, n))),
                M=10 ** rng.uniform(13.5, 15.0, n), z=rng.uniform(0.1, 0.3, n))
    raw = rng.exponential(1.0, NPIX)
    return [(C(**cols, cosmo=COSMO_DICT), S(map=raw, cosmo=COSMO_DICT))
            for C, S in ((JU.HaloLightConeCatalog, JU.LightconeShell),
                         (TU.HaloLightConeCatalog, TU.LightconeShell))]


@pytest.mark.parametrize("case", MESH_CASES)
def test_sharded_runner_matches_jax_mesh(jax_pairs, case):
    """The port's runner with ``halo_mesh(8, device="cpu")`` against the
    JAX runner with ``baryonforge_tpu.parallel.halo_mesh(8)`` (the virtual
    8-CPU mesh of tests/conftest.py) on the same catalog, map and model,
    float64 deposit and regrid, n_size_buckets=1: the shells to 1e-9 of the
    largest pixel change (tests/test_torch_shell.py), the grids to 1e-10
    of the largest move or value (tests/test_torch_grid.py); mass
    conserved to 1e-10."""
    kind, which = case.split("-")
    jkw = dict(dtype=jnp.float64, n_size_buckets=1, halo_batch=8,
               verbose=False, mesh=jparallel.halo_mesh(8))
    tkw = dict(dtype=torch.float64, n_size_buckets=1, device="cpu",
               mesh=MESH)
    if kind == "shell":
        (jcat, jshell), (tcat, tshell) = _shell_pair(
            np.random.default_rng(31))
        jm, tm = jax_pairs["dm3d"]
        dep = dict(deposit="scatter") if which == "scatter" else {}
        ref = np.asarray(JRunners.BaryonifyShell(
            jcat, jshell, epsilon_max=20, model=jm, regrid_dtype=jnp.float64,
            **dep, **jkw).process())
        tkw.pop("n_size_buckets")
        out = bf.BaryonifyShell(tcat, tshell, epsilon_max=20, model=tm,
                                regrid_dtype=torch.float64, **dep,
                                **tkw).process()
        raw, rel = np.asarray(tshell.map), 1e-9
    else:
        from test_torch_grid import grid_inputs
        z = 0.9 if which == "baryonify2d" else 0.2
        (jcat, jgm), (tcat, tgm) = grid_inputs(2, 64, 64.0, 24, z, seed=32)
        if which == "baryonify2d":
            jm, tm = jax_pairs["s19"]
            jcls, tcls, eps = JMap.BaryonifyGrid, bf.BaryonifyGrid, 20
        else:
            jm, tm = jax_pairs["dm"]
            jcls, tcls, eps = JMap.PaintProfilesGrid, bf.PaintProfilesGrid, 5
        ref = np.asarray(jcls(jcat, jgm, epsilon_max=eps, model=jm,
                              **jkw).process(), dtype=np.float64)
        out = tcls(tcat, tgm, epsilon_max=eps, model=tm, **tkw).process()
        raw = tgm.map if which == "baryonify2d" else None
        rel = 1e-10
    if raw is None:
        scale = np.abs(ref).max()
    else:
        scale = np.abs(ref - raw).max()
        np.testing.assert_allclose(out.sum(), raw.sum(), rtol=1e-10)
    assert scale > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * scale)


def test_sharded_shell_sums_overlapping_shards(models):
    """Halos that share pixels across shards (a crowded patch): the
    shards' offsets add up to the single run's (float64 deposit, 1e-12 of
    the largest move), so the sum is really taken."""
    model, _ = models
    rng = np.random.default_rng(8)
    n = 40
    cat = TU.HaloLightConeCatalog(
        ra=rng.uniform(40, 50, n), dec=rng.uniform(-5, 5, n),
        M=10 ** rng.uniform(14.0, 15.0, n), z=rng.uniform(0.1, 0.2, n),
        cosmo=COSMO_DICT)
    raw = rng.exponential(1.0, NPIX)
    shell = TU.LightconeShell(map=raw, cosmo=COSMO_DICT)
    for kw in (dict(deposit="scatter"), dict()):
        single = bf.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                                   dtype=torch.float64, device="cpu",
                                   **kw).process()
        sharded = bf.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                                    dtype=torch.float64, device="cpu",
                                    mesh=parallel.halo_mesh(3, "cpu"),
                                    **kw).process()
        scale = np.abs(single - raw).max()
        np.testing.assert_allclose(sharded, single, rtol=0,
                                   atol=1e-12 * scale)
        np.testing.assert_allclose(sharded.sum(), raw.sum(), rtol=1e-8)


@pytest.mark.parametrize("deposit", ["auto", "scatter"])
def test_anis_shell_sharded_matches_single(models, deposit):
    """test_multichip.py:75-94: the sharded anisotropic paint (its Mtot
    canvas sharded too) equals the single one to 1e-10."""
    _, tab = models
    rng = np.random.default_rng(22)
    cat = _cat(rng)
    shell = TU.LightconeShell(map=rng.exponential(1.0, NPIX),
                              cosmo=COSMO_DICT, redshift=0.25)
    kw = dict(epsilon_max=5, model=tab, Tracer_model=tab, Mtot_model=tab,
              background_val=1.0, global_tracer_fraction=0.1,
              deposit=deposit, device="cpu")
    single = bf.PaintProfilesAnisShell(cat, shell, **kw).process()
    runner = bf.PaintProfilesAnisShell(cat, shell, mesh=MESH, **kw)
    sharded = runner.process()
    assert runner._mtot_runner().mesh is MESH
    np.testing.assert_allclose(sharded, single, rtol=1e-10,
                               atol=1e-10 * np.abs(single).max())


def test_simple_parallel_concurrent_matches_sequential(models):
    """test_multichip.py:97-111: four shells from four threads (one model
    shared) equal a sequential loop."""
    model, _ = models
    rng = np.random.default_rng(23)
    cat = _cat(rng)
    shells = [TU.LightconeShell(map=rng.exponential(1.0, NPIX),
                                cosmo=COSMO_DICT) for _ in range(4)]
    seq = [bf.BaryonifyShell(cat, s, epsilon_max=20, model=model,
                             deposit="scatter", device="cpu").process()
           for s in shells]
    runners = [bf.BaryonifyShell(cat, s, epsilon_max=20, model=model,
                                 deposit="scatter", device="cpu")
               for s in shells]
    par = parallel.SimpleParallel(runners, njobs=4).process()
    assert len(par) == 4
    for a, b in zip(par, seq):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    # the default pool (one thread a runner), tiled runners too
    runners = [bf.BaryonifyShell(cat, s, epsilon_max=20, model=model,
                                 device="cpu") for s in shells[:2]]
    par = TU.SimpleParallel(runners).process()
    for r, out in zip(runners, par):
        np.testing.assert_array_equal(out, r.process())


def test_simple_parallel_paints(models):
    """test_runners_extra.py:111-122: two paint runners on zero shells."""
    _, tab = models
    cat = _cat(np.random.default_rng(24), 8)
    shells = [TU.LightconeShell(map=np.zeros(NPIX), cosmo=COSMO_DICT)
              for _ in range(2)]
    runners = [bf.PaintProfilesShell(cat, s, epsilon_max=5, model=tab,
                                     device="cpu") for s in shells]
    outs = parallel.SimpleParallel(runners).process()
    assert len(outs) == 2 and outs[0].max() > 0
    np.testing.assert_allclose(outs[0], outs[1])


@pytest.mark.parametrize("deposit", ["scatter", "auto"])
def test_splitjoin_paint(models, deposit):
    """test_multichip.py:114-129: SplitJoinParallel on a paint runner, at
    rtol 1e-12 / atol 1e-15; the runner itself keeps no mesh."""
    _, tab = models
    cat = _cat(np.random.default_rng(25))
    shell = TU.LightconeShell(map=np.zeros(NPIX), cosmo=COSMO_DICT)
    runner = bf.PaintProfilesShell(cat, shell, epsilon_max=5, model=tab,
                                   deposit=deposit, dtype=torch.float64,
                                   device="cpu")
    single = runner.process()
    out = parallel.SplitJoinParallel(runner, mesh=MESH).process()
    assert runner.mesh is None
    np.testing.assert_allclose(out, single, rtol=1e-12, atol=1e-15)
    # njobs without a mesh: that many CPU shards
    out = parallel.SplitJoinParallel(runner, njobs=3).process()
    np.testing.assert_allclose(out, single, rtol=1e-12, atol=1e-15)


@pytest.fixture(scope="module")
def grids():
    rng = np.random.default_rng(26)
    N, L, n = 24, 60.0, 30
    bins = (np.arange(N) + 0.5) * (L / N)
    kw = dict(M=10 ** rng.uniform(13.0, 14.8, n), redshift=0.2,
              cosmo=COSMO_DICT)
    pos = rng.uniform(0, L, (n, 3))
    cat3 = TU.HaloNDCatalog(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2], **kw)
    cat2 = TU.HaloNDCatalog(x=pos[:, 0], y=pos[:, 1], **kw)
    gm3 = TU.GriddedMap(map=rng.exponential(1.0, (N, N, N)), bins=bins,
                        cosmo=COSMO_DICT, redshift=0.2)
    gm2 = TU.GriddedMap(map=rng.exponential(1.0, (2 * N, 2 * N)),
                        bins=(np.arange(2 * N) + 0.5) * (L / (2 * N)),
                        cosmo=COSMO_DICT, redshift=0.2)
    return cat3, gm3, cat2, gm2, pos, L


@pytest.mark.parametrize("which", ["baryonify3d", "baryonify2d", "paint3d",
                                   "paint2d", "anis2d"])
def test_grid_runners_with_a_mesh(models, grids, which):
    """Each grid runner with a mesh against none: its size buckets are the
    whole catalog's (a shard paints its halos of each bucket at the
    bucket's size); float32 offsets within 1e-5 of the largest move and
    mass to 1e-10, float64 paints to 1e-12 of the largest value."""
    model, tab = models
    cat3, gm3, cat2, gm2, _, _ = grids
    cat, gm = (cat3, gm3) if which.endswith("3d") else (cat2, gm2)
    if which.startswith("baryonify"):
        cls, kw = bf.BaryonifyGrid, dict(epsilon_max=20, model=model)
    elif which.startswith("paint"):
        cls, kw = bf.PaintProfilesGrid, dict(epsilon_max=5, model=tab,
                                             dtype=torch.float64)
    else:
        cls, kw = bf.PaintProfilesAnisGrid, dict(
            epsilon_max=5, model=tab, Tracer_model=tab, Mtot_model=tab,
            background_val=1.0, global_tracer_fraction=0.1,
            dtype=torch.float64)
    single = cls(cat, gm, device="cpu", **kw).process()
    sharded = cls(cat, gm, device="cpu", mesh=MESH, **kw).process()
    if which.startswith("baryonify"):
        scale = np.abs(single - gm.map).max()
        assert scale > 0
        np.testing.assert_allclose(sharded, single, rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(sharded.sum(), gm.map.sum(), rtol=1e-10)
    else:
        np.testing.assert_allclose(sharded, single, rtol=0,
                                   atol=1e-12 * np.abs(single).max())


@pytest.mark.parametrize("ndim", [2, 3])
def test_snapshot_with_a_mesh(models, grids, ndim):
    """tests/test_snapshot.py:71-88: the sharded displacement equals the
    single one to 2e-5 (float32 association), with shards that have no
    pairs skipped; the shard rows are cached with the pairs."""
    model, _ = models
    _, _, _, _, hpos, L = grids
    rng = np.random.default_rng(27)
    n_part = 6000
    p = rng.uniform(0, L, (n_part, ndim))
    cols = dict(zip("xyz", p.T))
    snap = TU.ParticleSnapshot(M=np.ones(n_part), L=L, cosmo=COSMO_DICT,
                               redshift=0.2, **cols)
    h = dict(zip("xyz", hpos[:, :ndim].T))
    cat = TU.HaloNDCatalog(M=10 ** rng.uniform(13.0, 14.8, len(hpos)),
                           redshift=0.2, cosmo=COSMO_DICT, **h)
    single = bf.BaryonifySnapshot(cat, snap, epsilon_max=20, model=model,
                                  device="cpu").process()
    runner = bf.BaryonifySnapshot(cat, snap, epsilon_max=20, model=model,
                                  device="cpu",
                                  mesh=parallel.halo_mesh(40, "cpu"))
    for _ in range(2):
        sharded = runner.process()
        moved = 0.0
        for c in "xyz"[:ndim]:
            dx = np.asarray(sharded[c]) - np.asarray(single[c])
            dx = np.where(dx > L / 2, dx - L, dx)
            dx = np.where(dx < -L / 2, dx + L, dx)
            np.testing.assert_allclose(dx, 0.0, atol=2e-5)
            moved = max(moved, np.abs(np.asarray(single[c]) - cols[c]).max())
        assert moved > 0
    assert list(runner._pairs[3]) == [40]


def test_shared_state_under_threads(models):
    """Sixteen threads with a short switch interval: every launch count
    kept (``_build.count``), one cast set a (dtype, device) made for a
    shared model (``ops.interp.cast_copy``) with one CurveTable, and the
    shared TabulatedCorrelation3D copy; the pool finishes within its
    timeout."""
    import sys
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from baryonforge_torch.ops import _build, interp
    model, _ = models
    model.__dict__.pop("_casts", None)            # the casts made anew
    tab = TU.TabulatedCorrelation3D.from_arrays(
        np.linspace(0, 1, 3), np.log(np.geomspace(1e-2, 1e2, 16)),
        np.ones((3, 16)), device="cpu")
    barrier = threading.Barrier(16)

    def work(_):
        barrier.wait(timeout=30)
        for _ in range(500):
            _build.count("stress")
        m = model.with_dtype(torch.float32)
        ct = interp.curve_table(m, "_table")
        return m._axes, ct, tab(torch.ones(4, dtype=torch.float64), 0.9)
    old = sys.getswitchinterval()
    _build.reset_launches()
    try:
        sys.setswitchinterval(1e-6)
        with ThreadPoolExecutor(max_workers=16) as ex:
            outs = [f.result(timeout=60) for f in
                    [ex.submit(work, i) for i in range(16)]]
    finally:
        sys.setswitchinterval(old)
    assert _build.launches["stress"] == 16 * 500
    axes, cts, xi = zip(*outs)
    assert all(a[0] is axes[0][0] for a in axes)
    assert all(c is cts[0] for c in cts)
    assert all(torch.equal(x, xi[0]) for x in xi)
    _build.reset_launches()
