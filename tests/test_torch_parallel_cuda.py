"""The last modules on the card (marked ``cuda``: each test skips without a
CUDA device): the runners with ``halo_mesh(4, device="cuda")`` (four
shards of one card, each on a CUDA stream of its own) against none, and
against the CPU's sharded run; SimpleParallel's threads sharing a model
whose casts are not made yet, and an empty process-wide geometry cache;
TabulatedCorrelation3D, the profile cache and halomodel_power on the card
against the CPU. This file imports no jax: on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch import parallel                      # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402

pytestmark = pytest.mark.cuda

TABLE = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                     "_northstar_table.npz")
COSMO = dict(Omega_m=0.30, Omega_b=0.045, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
H = 0.7
BPAR = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / H, mu_beta=0.4,
            eta=0.3, eta_delta=0.3, tau=-1.5, tau_delta=0,
            A=0.09 / 2, M1=2.5e11 / H, epsilon_h=0.015,
            a=0.3, n=2, epsilon=4, p=0.3, q=0.707, gamma=2, delta=7)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model():
    return bf.Baryonification2D(
        None, None, bf.cosmo.cosmology_from_dict(COSMO),
        epsilon_max=20).load_table(TABLE)


def _inputs(nside, n, seed):
    rng = np.random.default_rng(seed)
    cat = bf.utils.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
        M=10 ** rng.uniform(13.0, 14.8, n), z=rng.uniform(0.8, 1.0, n),
        cosmo=COSMO)
    shell = bf.utils.LightconeShell(
        map=rng.exponential(1.0, 12 * nside * nside), cosmo=COSMO)
    return cat, shell


@pytest.mark.parametrize("kw", [dict(), dict(deposit="scatter")],
                         ids=["tiled", "scatter"])
def test_sharded_shell_on_the_card(dev, kw):
    """The shell with four shards of the card against none (1e-4 of the
    largest move, tests/test_multichip.py:66-69) and against the CPU's
    sharded run (float64 deposit and regrid: 1e-9 of it)."""
    cat, shell = _inputs(256, 2000, 5)
    model = _model()
    common = dict(epsilon_max=20, model=model, dtype=torch.float64)
    single = bf.BaryonifyShell(cat, shell, device=dev, **common,
                               **kw).process()
    _build.reset_launches()
    sharded = bf.BaryonifyShell(cat, shell, device=dev,
                                mesh=parallel.halo_mesh(4, "cuda"),
                                **common, **kw).process()
    k = "disc_deposit" if kw else "tile_deposit"
    assert _build.launches[k] >= 4
    cpu = bf.BaryonifyShell(cat, shell, device="cpu",
                            mesh=parallel.halo_mesh(4, "cpu"), **common,
                            **kw).process()
    scale = np.abs(single - shell.map).max()
    assert scale > 0
    np.testing.assert_allclose(sharded, single, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(sharded, cpu, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(sharded.sum(), shell.map.sum(), rtol=1e-8)


def test_sharded_paints_grid_and_snapshot_on_the_card(dev):
    """The scatter paint through SplitJoinParallel (rtol 1e-12), a 3D
    BaryonifyGrid (1e-5 of the largest move) and a snapshot (2e-5 in
    position) with four shards of the card against none."""
    cat, shell = _inputs(128, 500, 6)
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    tab = bf.utils.TabulatedProfile(bf.Profiles.DarkMatter(
        **BPAR, proj_cutoff=100), cosmo, device=dev).setup_interpolator(
        z_min=0.7, z_max=1.1, N_samples_z=2, M_min=5e12, M_max=2e15,
        N_samples_Mass=4, R_min=1e-3, R_max=60, N_samples_R=32)
    mesh = parallel.halo_mesh(4, "cuda")
    runner = bf.PaintProfilesShell(cat, shell, epsilon_max=5, model=tab,
                                   deposit="scatter", device=dev)
    single = runner.process()
    split = parallel.SplitJoinParallel(runner, mesh=mesh).process()
    np.testing.assert_allclose(split, single, rtol=1e-12, atol=1e-15)

    model3 = bf.Baryonification3D(
        bf.Profiles.DarkMatter(**BPAR),
        bf.Profiles.DarkMatter(**{**BPAR, "epsilon": 2.0}), cosmo,
        epsilon_max=20, device=dev).setup_interpolator(
        z_min=0.1, z_max=0.3, N_samples_z=2, M_min=1e13, M_max=1e15,
        N_samples_Mass=4, R_min=1e-3, R_max=50, N_samples_R=32)
    rng = np.random.default_rng(7)
    N, L, n = 48, 96.0, 60
    pos = rng.uniform(0, L, (n, 3))
    hcat = bf.utils.HaloNDCatalog(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2],
                                  M=10 ** rng.uniform(13.0, 14.8, n),
                                  redshift=0.2, cosmo=COSMO)
    gm = bf.utils.GriddedMap(map=rng.exponential(1.0, (N,) * 3),
                             bins=(np.arange(N) + 0.5) * (L / N),
                             cosmo=COSMO, redshift=0.2)
    a = bf.BaryonifyGrid(hcat, gm, epsilon_max=20, model=model3,
                         device=dev).process()
    b = bf.BaryonifyGrid(hcat, gm, epsilon_max=20, model=model3,
                         mesh=mesh, device=dev).process()
    np.testing.assert_allclose(b, a, rtol=0,
                               atol=1e-5 * np.abs(a - gm.map).max())
    p = rng.uniform(0, L, (20000, 3))
    snap = bf.utils.ParticleSnapshot(x=p[:, 0], y=p[:, 1], z=p[:, 2],
                                     M=np.ones(len(p)), L=L, cosmo=COSMO,
                                     redshift=0.2)
    a = bf.BaryonifySnapshot(hcat, snap, epsilon_max=20, model=model3,
                             device=dev).process()
    b = bf.BaryonifySnapshot(hcat, snap, epsilon_max=20, model=model3,
                             mesh=mesh, device=dev).process()
    for c in "xyz":
        d = np.asarray(b[c]) - np.asarray(a[c])
        d = np.where(d > L / 2, d - L, np.where(d < -L / 2, d + L, d))
        np.testing.assert_allclose(d, 0.0, atol=2e-5)


def test_simple_parallel_shares_a_fresh_model(dev):
    """Four shell runners from four threads, sharing one model whose casts
    and K1 set-ups are made in the threads: equal to a sequential run
    (1e-12), every launch counted."""
    cat, shell = _inputs(128, 800, 8)
    rng = np.random.default_rng(9)
    shells = [bf.utils.LightconeShell(map=rng.exponential(1.0,
                                                          shell.map.size),
                                      cosmo=COSMO) for _ in range(4)]
    seq = [bf.BaryonifyShell(cat, s, epsilon_max=20, model=_model(),
                             device=dev).process() for s in shells]
    model = _model()
    runners = [bf.BaryonifyShell(cat, s, epsilon_max=20, model=model,
                                 device=dev) for s in shells]
    _build.reset_launches()
    par = parallel.SimpleParallel(runners, njobs=4).process()
    assert _build.launches["collapse_curves"] == 4
    assert _build.launches["tile_deposit"] == 4
    for a, b in zip(par, seq):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["shell", "paint"])
def test_simple_parallel_fills_the_geometry_once(dev, kind):
    """Four tiled runners through SimpleParallel(njobs=4) from an empty
    process-wide geometry cache, so that their threads ask for its entries
    at once: the four calls fill it once between them (their fills add up
    to one cold runner's) and give the sequential maps: the paint's bit
    for bit, the shell's to the order of K6's atomic sums, which changes
    from run to run (1e-12, as the test above)."""
    if kind == "shell":
        model = _model()
    else:
        model = bf.utils.TabulatedProfile(bf.Profiles.DarkMatter(
            **BPAR, proj_cutoff=100), bf.cosmo.cosmology_from_dict(COSMO),
            device=dev).setup_interpolator(
            z_min=0.7, z_max=1.1, N_samples_z=2, M_min=5e12, M_max=2e15,
            N_samples_Mass=4, R_min=1e-3, R_max=60, N_samples_R=32)
    cases = [_inputs(128, 800, 20 + i) for i in range(4)]

    def make(cat, shell):
        if kind == "shell":
            return bf.BaryonifyShell(cat, shell, epsilon_max=20,
                                     model=model, device=dev)
        return bf.PaintProfilesShell(cat, shell, epsilon_max=5, model=model,
                                     device=dev)
    bf.clear_geometry_cache()
    seq, fills = [], []
    for c in cases:
        r = make(*c)
        seq.append(r.process())
        fills.append(r.timings.get("count.cache_fills", 0))
    assert fills[0] > 0 and not any(fills[1:])
    bf.clear_geometry_cache()
    runners = [make(*c) for c in cases]
    par = parallel.SimpleParallel(runners, njobs=4).process()
    assert sum(r.timings.get("count.cache_fills", 0)
               for r in runners) == fills[0]
    for a, b in zip(par, seq):
        if kind == "paint":
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_last_utils_on_the_card(dev):
    """TabulatedCorrelation3D built on the card against the CPU's (1e-9 of
    max |xi|), its readout on the radii's device; a CachedProfile hit on
    the card equal to its miss and on the card; halomodel_power card vs
    CPU (1e-9 relative)."""
    from baryonforge_torch.utils import halomodel as hm
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    grid = dict(R_range=(1e-2, 1e2), N_samples_R=64, z_range=(0.0, 1.5),
                N_samples_z=4)
    _build.reset_launches()
    tc = bf.utils.TabulatedCorrelation3D(cosmo, device=dev, **grid)
    assert _build.launches["fht"] == 4
    tcpu = bf.utils.TabulatedCorrelation3D(cosmo, device="cpu", **grid)
    scale = float(tcpu._tab.abs().max())
    assert float((tc._tab.cpu() - tcpu._tab).abs().max()) <= 1e-9 * scale
    r = torch.as_tensor(np.geomspace(5e-3, 2e2, 50))
    got = tc(r.to(dev), 0.7)
    assert got.device.type == "cuda"
    assert float((got.cpu() - tcpu(r, 0.7)).abs().max()) <= 1e-9 * scale
    assert tcpu(r.to(dev), 0.7).device.type == "cuda"

    cached = bf.utils.CachedProfile(bf.Profiles.DarkMatter(**BPAR))
    rr = torch.as_tensor(np.geomspace(1e-2, 50, 24), device=dev)
    M = torch.as_tensor(np.geomspace(1e13, 1e15, 4), device=dev)
    a1 = cached.real(cosmo, rr, M, 0.8)
    a2 = cached.real(cosmo, rr, M, 0.8)
    assert a2.device.type == "cuda" and torch.equal(a1, a2)
    assert len(cached.cache) == 1

    k = np.geomspace(1e-3, 10, 8)
    out = []
    for d in (dev, "cpu"):
        dm = bf.Profiles.DarkMatter(**BPAR)
        hmc = hm.FlexibleHMCalculator(
            mass_function=hm.MassFuncTinker08(device=d),
            halo_bias=hm.HaloBiasShethTormen(device=d),
            halo_m_to_mtot=bf.Profiles.misc.Mdelta_to_Mtot(dm),
            log10M_min=10, log10M_max=16, nM=32, device=d)
        out.append(hm.halomodel_power(cosmo, k, 1.0, dm, hmc).cpu())
    torch.testing.assert_close(out[0], out[1], rtol=1e-9, atol=0)
