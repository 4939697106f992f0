"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. This file imports
no jax, so it also runs where only torch is installed; the repository's
tests/conftest.py imports jax, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float64 to 1e-10 of the largest value (atomic sums in another
order); K8 (FFTLog) to 1e-11 of the largest value (direct DFT sums against
torch.fft's: two correct summation orders differ by up to ~4e-12 of it on
wide grids), K9 (table rows) to 1e-12 with equal NaN masks; float32
deposits to the JAX package's edge-jitter bounds
(tests/test_tiled_deposit.py:61-63); float32 regrids to the float32
weight noise, 1e-6 * nside of the largest source value. The tile layouts
(K7), the hot-tile test (K5) and the source list's integers (K6) must be
equal; its angles agree to a few ulps (the device's asin against torch's).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import deposit, interp, regrid   # noqa: E402
from baryonforge_torch.ops import stencil, tile_deposit     # noqa: E402
from baryonforge_torch.ops import fftlog, table_rows        # noqa: E402
from baryonforge_torch.ops import tiles as tt               # noqa: E402

pytestmark = pytest.mark.cuda

TABLE = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                     "_northstar_table.npz")
COSMO = dict(Omega_m=0.30, Omega_b=0.045, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model():
    return bf.Baryonification2D(
        None, None, bf.cosmo.cosmology_from_dict(COSMO),
        epsilon_max=20).load_table(TABLE)


def _inputs(nside, n, seed=7):
    """Bench-like halos, two at the poles, some near the caps, a third at
    the table's lowest masses (the fewer-than-4-pixels fallback)."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    dec[2:10] = rng.uniform(77, 84, 8) * rng.choice([-1, 1], 8)
    dec[0], dec[1] = 89.5, -89.5
    M = 10 ** rng.uniform(13.0, 14.8, n)
    M[2::3] = 10 ** rng.uniform(12.71, 12.8, M[2::3].size)
    z = rng.uniform(0.8, 1.0, n)
    cat = bf.utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                        cosmo=COSMO)
    shell = bf.utils.LightconeShell(
        map=rng.exponential(1.0, 12 * nside * nside), cosmo=COSMO)
    return cat, shell


def _prep(nside, n, dt, dev):
    cat, shell = _inputs(nside, n)
    r = bf.BaryonifyShell(cat, shell, epsilon_max=20, model=_model(),
                          device=dev)
    hd = r._host_halo_data(bf.cosmo.cosmology_from_dict(r.cosmo))
    halos = r._halo_tensors(hd)
    m = _model().with_dtype(dt, device=dev)
    curves, r0, dl = interp.collapse_curves_plain(
        m._table, m._axes, 2, hd["M"], hd["a"], [], {})
    return shell, hd, m, halos, curves, float(r0), float(dl)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_collapse_curves_kernel(dev, dt):
    _, hd, m, _, cp, _, _ = _prep(64, 500, dt, dev)
    _build.reset_launches()
    ck, _, _ = interp.collapse_curves(m._table, m._axes, 2, hd["M"],
                                      hd["a"], [], {})
    assert _build.launches["collapse_curves"] == 1
    rel = 1e-6 if dt == torch.float32 else 1e-12
    torch.testing.assert_close(ck, cp, rtol=rel,
                               atol=rel * cp.abs().max().item())


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside,n", [(64, 300), (256, 400)])
def test_disc_deposit_kernel(dev, dt, nside, n):
    _, _, _, halos, curves, r0, dl = _prep(nside, n, dt, dev)
    _build.reset_launches()
    pk = deposit.disc_deposit(nside, halos, curves, r0, dl, 20)
    assert _build.launches["disc_deposit"] == 1
    pp = deposit.disc_deposit_plain(nside, halos, curves, r0, dl, 20)
    scale = pp.abs().max().item()
    assert scale > 0
    if dt == torch.float64:
        torch.testing.assert_close(pk, pp, rtol=0, atol=1e-10 * scale)
    else:
        torch.testing.assert_close(pk, pp, rtol=0, atol=0.02 * scale)
        assert (pk - pp).abs().sum() < 3e-3 * pp.abs().sum()


@pytest.mark.parametrize("pdt", DTYPES, ids=["po32", "po64"])
@pytest.mark.parametrize("rdt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [64, 256])
def test_regrid_kernel(dev, pdt, rdt, nside):
    shell, _, _, halos, curves, r0, dl = _prep(nside, 300, pdt, dev)
    po = deposit.disc_deposit_plain(nside, halos, curves, r0, dl, 20)
    # and push the polar pixels through the poles
    theta = bf.ops.healpix.pix2ang(
        nside, torch.arange(12 * nside * nside, dtype=torch.int32,
                            device=dev))[0]
    cap = theta < 2.0 / nside
    po[cap, 0] = (-1.7 * theta[cap]).to(pdt)
    orig = torch.as_tensor(shell.map, device=dev).to(rdt)
    _build.reset_launches()
    ok = regrid.regrid(nside, po, orig)
    assert _build.launches["regrid"] == 1
    op = regrid.regrid_plain(nside, po, orig)
    if rdt == torch.float64:
        atol = 1e-9 * (op - orig).abs().max().item()
    else:
        atol = 1e-6 * nside * orig.abs().max().item()
    torch.testing.assert_close(ok, op, rtol=0, atol=atol)
    assert abs(ok.double().sum().item() / orig.double().sum().item()
               - 1) < 1e-5


def test_shell_cuda_matches_cpu(dev):
    """The whole default path (the tiled engine; at NSIDE 64 every disc of
    this catalog is small, so phase A is K2 through K7's tile_view) on the
    card against the plain versions on the CPU, float64
    (tests/test_tiled_deposit.py:80's bound)."""
    cat, shell = _inputs(64, 300)
    kw = dict(epsilon_max=20, model=_model(), dtype=torch.float64,
              regrid_dtype=torch.float64)
    _build.reset_launches()
    out_gpu = bf.BaryonifyShell(cat, shell, device=dev, **kw).process()
    assert all(_build.launches[k] >= 1
               for k in ("collapse_curves", "disc_deposit", "tile_view",
                         "stencil_hot", "stencil", "flat_view",
                         "stencil_complement"))
    out_cpu = bf.BaryonifyShell(cat, shell, device="cpu", **kw).process()
    scale = np.abs(out_cpu - shell.map).max()
    np.testing.assert_allclose(out_gpu, out_cpu, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("deposit_mode,regrid_mode,nside",
                         [("auto", "auto", 256), ("tiles", "scatter", 256),
                          ("scatter", "scatter", 64)])
def test_shell_paths_cuda_match_cpu(dev, deposit_mode, regrid_mode, nside):
    """Each engine on the card against the CPU, float64: the tiled engine
    at NSIDE 256 (K4 and K5 at work), its tiles + scatter-regrid mix, and
    the scatter path."""
    cat, shell = _inputs(nside, 300)
    kw = dict(epsilon_max=20, model=_model(), dtype=torch.float64,
              regrid_dtype=torch.float64, deposit=deposit_mode,
              regrid=regrid_mode)
    _build.reset_launches()
    out_gpu = bf.BaryonifyShell(cat, shell, device=dev, **kw).process()
    want = {("auto", "auto"): ("tile_deposit", "stencil", "flat_view"),
            ("tiles", "scatter"): ("tile_deposit", "flat_view", "regrid"),
            ("scatter", "scatter"): ("disc_deposit", "regrid")}
    assert all(_build.launches[k] >= 1
               for k in want[(deposit_mode, regrid_mode)]), _build.launches
    out_cpu = bf.BaryonifyShell(cat, shell, device="cpu", **kw).process()
    scale = np.abs(out_cpu - shell.map).max()
    np.testing.assert_allclose(out_gpu, out_cpu, rtol=0, atol=1e-9 * scale)


# ---- K1 with parameter axes ------------------------------------------------
@pytest.mark.parametrize("n_p", [1, 2])
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_collapse_curves_kernel_p_keys(dev, dt, n_p):
    rng = np.random.default_rng(15)
    shape = (5, 7, 16) + (4, 3)[:n_p]
    axes = tuple(torch.as_tensor(np.cumsum(rng.uniform(0.2, 1.0, n)),
                                 dtype=dt, device=dev) for n in shape)
    table = torch.as_tensor(rng.normal(size=shape), dtype=dt, device=dev)
    n = 500
    M = np.exp(rng.uniform(axes[1][0].item(), axes[1][-1].item(), n))
    a = 1.0 / np.exp(rng.uniform(axes[0][0].item(), axes[0][-1].item(), n))
    p = {f"p{k}": rng.uniform(axes[3 + k][0].item() - 0.1,
                              axes[3 + k][-1].item() + 0.1, n)
         for k in range(n_p)}
    args = (table, axes, 2, M, a, sorted(p), p)
    _build.reset_launches()
    ck, _, _ = interp.collapse_curves(*args, fill=-3.0)
    assert _build.launches["collapse_curves"] == 1
    cp, _, _ = interp.collapse_curves_plain(*args, fill=-3.0)
    rel = 1e-6 if dt == torch.float32 else 1e-12
    torch.testing.assert_close(ck, cp, rtol=rel,
                               atol=rel * cp.abs().max().item())
    assert (cp == -3.0).any() and (cp != -3.0).any()


# ---- the tiled engine's kernels: K4, K5, K6, K7 ----------------------------
def _tiled(nside, eps, dt, dev):
    """The tile deposit's inputs for every halo of the test catalog (the
    runner's own host pieces), with curves from K1's plain version."""
    cat, shell = _inputs(nside, 300)
    r = bf.BaryonifyShell(cat, shell, epsilon_max=eps, model=_model(),
                          dtype=dt, device=dev)
    hd = r._host_halo_data(bf.cosmo.cosmology_from_dict(r.cosmo))
    tiling = r._get_tiling(nside)
    st = np.sin(hd["theta"])
    vh = np.stack([st * np.cos(hd["phi"]), st * np.sin(hd["phi"]),
                   np.cos(hd["theta"])], 1)
    t_ids, h_ids = tt.bin_halos_to_tiles(tiling, hd["theta"], hd["phi"],
                                         hd["radius"])
    t_ids, h_ids = tt.refine_pairs(
        tiling, t_ids, h_ids, vh,
        2.0 * np.sin(np.minimum(hd["radius"], np.pi) / 2.0))
    csr = tuple(torch.as_tensor(x, device=dev)
                for x in tt.pairs_csr(t_ids, h_ids))
    pack = r._tile_base_pack(hd)
    m = _model().with_dtype(dt, device=dev)
    pack["curves"], r0, dl = interp.collapse_curves_plain(
        m._table, m._axes, 2, hd["M"], hd["a"], [], {})
    return r, shell, tiling, csr, pack, float(r0), 1.0 / float(dl)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside,eps", [(64, 60), (256, 20)])
def test_tile_deposit_kernel(dev, dt, nside, eps):
    _, _, tiling, csr, pack, r0, inv = _tiled(nside, eps, dt, dev)
    assert csr[0].numel() > 0
    _build.reset_launches()
    ak = tile_deposit.tile_deposit(tiling, csr, pack, r0, inv)
    assert _build.launches["tile_deposit"] == 1
    ap = tile_deposit.tile_deposit_plain(tiling, csr, pack, r0, inv)
    scale = ap.abs().max().item()
    assert scale > 0
    if dt == torch.float64:
        torch.testing.assert_close(ak, ap, rtol=0, atol=1e-10 * scale)
    else:
        torch.testing.assert_close(ak, ap, rtol=0, atol=0.02 * scale)
        assert (ak - ap).abs().sum() < 3e-3 * ap.abs().sum()


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [64, 256])
def test_tile_layout_kernel(dev, dt, nside):
    tiling = tt.SkyTiling(nside)
    g = torch.Generator(device=dev).manual_seed(3)
    for trail in ((), (2,)):
        flat = torch.randn((tiling.npix,) + trail, dtype=dt, device=dev,
                           generator=g)
        _build.reset_launches()
        tk = tiling.tile_view(flat)
        fk = tiling.flat_view(tk)
        assert _build.launches["tile_view"] == _build.launches[
            "flat_view"] == 1
        assert torch.equal(tk, tiling.tile_view_plain(flat))
        assert torch.equal(fk, tiling.flat_view_plain(tk))
        assert torch.equal(fk, flat)


@pytest.mark.parametrize("pdt,rdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.float64),
                                     (torch.float64, torch.float64)],
                         ids=["f32-f32", "f32-f64", "f64-f64"])
@pytest.mark.parametrize("nside,eps", [(64, 60), (256, 20)])
def test_stencil_kernels(dev, pdt, rdt, nside, eps):
    """K5 (hot test, stencil) and K6 (source list, complement) against
    their plain versions on the tile deposit's offsets, with the polar
    rings pushed through the poles and two tiles made hot."""
    r, shell, tiling, csr, pack, r0, inv = _tiled(nside, eps, pdt, dev)
    acc = tile_deposit.tile_deposit_plain(tiling, csr, pack, r0, inv)
    acc[tiling.n_tiles // 3, :, 0] = 0.05
    acc[2 * tiling.n_tiles // 3, 5:40, 1] = -0.05
    tables = r._stencil_tables(nside)
    orig = torch.as_tensor(shell.map, device=dev).to(rdt)
    og_t = tiling.tile_view(orig)
    _build.reset_launches()
    ek = stencil.hot_tiles(acc, tables)
    ep = stencil.hot_tiles_plain(acc, tables)
    assert torch.equal(ek, ep)
    hot = torch.nonzero(ek & ~tables["D_geom"])[:, 0].to(torch.int32)
    assert nside < 256 or (hot.numel() >= 2 and not ek.all())
    ok = stencil.stencil_regrid(tiling, tables, acc, og_t, ek)
    op = stencil.stencil_regrid_plain(tiling, tables, acc, og_t, ek)
    tol = (1e-12 if rdt == torch.float64 else 1e-5) \
        * orig.abs().max().item()
    torch.testing.assert_close(ok, op, rtol=0, atol=tol)
    gk = stencil.stencil_geo(tiling, tables, rdt)
    gp = stencil.stencil_geo_plain(tiling, tables, rdt)
    for a, b in zip(gk[:2], gp[:2]):
        assert torch.equal(a, b)
    for a, b in zip(gk[2:], gp[2:]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=16 * torch.finfo(rdt).eps)
    base = tiling.flat_view(op)
    fk = stencil.stencil_complement(tiling, base.clone(), acc, og_t, gk, hot)
    fp = stencil.stencil_complement_plain(tiling, base.clone(), acc, og_t,
                                          gp, hot)
    assert all(_build.launches[k] == 1 for k in
               ("stencil_hot", "stencil", "stencil_geo",
                "stencil_complement"))
    if rdt == torch.float64:
        atol = 1e-9 * (fp - orig).abs().max().item()
    else:
        atol = 1e-6 * nside * orig.abs().max().item()
    torch.testing.assert_close(fk, fp, rtol=0, atol=atol)
    assert abs(fk.double().sum().item() / orig.double().sum().item()
               - 1) < 1e-5


# ---- the table build: K8 FFTLog, K9 table rows -----------------------------
@pytest.mark.parametrize("B,N,mu,q", [(1, 1024, 0.5, -0.5),
                                      (20, 2048, 0.5, -0.5),
                                      (20, 2048, 0.0, -0.5),
                                      (3, 100, 0.0, -1.0)])
def test_fht_kernel(dev, B, N, mu, q):
    """K8 on correlation_3d's grid (B = 1, N = 1024), on a Fourier-like
    batch (B = 20, N = 2048) and on a length that is no power of two with
    q on a Gamma pole, against its plain version."""
    rng = np.random.default_rng(N)
    x = torch.as_tensor(np.geomspace(1e-4, 1e4, N), device=dev)
    a = torch.as_tensor(np.exp(-np.geomspace(1e-4, 1e4, N)[None]
                               * rng.uniform(0.5, 2.0, (B, 1))), device=dev)
    _build.reset_launches()
    k, ok = fftlog.fht(x, a, mu, q)
    assert _build.launches["fht"] == 1
    lx, ln_kcrc = fftlog._fht_grids(x, 1.0)
    op = fftlog.fht_plain(a, lx, mu, fftlog._safe_q(mu, q), ln_kcrc)
    # each row to 1e-11 of its own largest value (two correct summation
    # orders differ by 2.2e-12: test_torch_fftlog.py)
    assert ok.shape == op.shape and ok.dtype == op.dtype
    rel = ((ok - op).abs() / op.abs().amax(-1, keepdim=True)).max().item()
    assert rel <= 1e-11, rel


def _bench_model(dev):
    h = 0.7
    bpar = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / h, mu_beta=0.4,
                eta=0.3, eta_delta=0.3, tau=-1.5, tau_delta=0,
                A=0.09 / 2, M1=2.5e11 / h, epsilon_h=0.015,
                a=0.3, n=2, epsilon=4, p=0.3, q=0.707, gamma=2, delta=7)
    return bf.Baryonification2D(
        bf.Profiles.DarkMatterOnly(**bpar, proj_cutoff=100),
        bf.Profiles.DarkMatterBaryon(**bpar, proj_cutoff=100),
        bf.cosmo.cosmology_from_dict(COSMO), epsilon_max=20, device=dev)


def test_table_rows_kernel(dev):
    """K9 on the bench table's first redshift (20 masses, 64 radii, 500
    integration points), against its plain versions on the same inputs."""
    m = _bench_model(dev)
    r = np.geomspace(1e-3, 60, 64)
    M = np.geomspace(5e12, 2e15, 20)
    a = 1.0 / 1.7
    r_int = np.geomspace(min(r.min(), m.r_min_int) / 1.2,
                         max(r.max(), m.r_max_int) * 1.2, m.N_int)
    lnr_int = torch.log(torch.as_tensor(r_int, device=dev))
    lnr = torch.log(torch.as_tensor(r, device=dev))
    dl = float(np.log(r_int[1] / r_int[0]))
    masses = []
    _build.reset_launches()
    for prof in (m.DMO, m.DMB):
        dens = prof.projected(m.cosmo, r_int, torch.as_tensor(M, device=dev),
                              a) * a
        intgd = 2 * np.pi * torch.exp(lnr_int) ** 2 * dens * dl
        dens, intgd = dens.clamp(min=0), intgd.clamp(min=0)
        ek = table_rows.enclosed_mass(intgd, dens, lnr_int, lnr)
        ep = table_rows.enclosed_mass_plain(intgd, dens, lnr_int, lnr)
        assert torch.equal(torch.isnan(ek), torch.isnan(ep))
        torch.testing.assert_close(ek, ep, rtol=1e-12, atol=0,
                                   equal_nan=True)
        masses.append(ep)
    dk = table_rows.displacement_rows(lnr, *masses)
    dp = table_rows.displacement_rows_plain(lnr, *masses)
    assert _build.launches["enclosed_mass"] == 2
    assert _build.launches["displacement_rows"] == 1
    assert torch.equal(torch.isnan(dk), torch.isnan(dp))
    torch.testing.assert_close(dk, dp, rtol=0, equal_nan=True,
                               atol=1e-12 * dp.nan_to_num().abs().max().item())


def test_table_build_cuda_matches_cpu(dev):
    """setup_interpolator on the card (K8, K9) against the plain versions
    on the CPU, 2 z x 4 M x 16 r, to 1e-9 of the largest |d|."""
    kw = dict(z_min=0.7, z_max=1.1, N_samples_z=2, M_min=5e12, M_max=2e15,
              N_samples_Mass=4, R_min=1e-3, R_max=60, N_samples_R=16,
              verbose=False)
    _build.reset_launches()
    g = _bench_model(dev).setup_interpolator(**kw)
    assert _build.launches["fht"] == 2 * 2
    assert _build.launches["enclosed_mass"] == 2 * 2
    assert _build.launches["displacement_rows"] == 2
    c = _bench_model("cpu").setup_interpolator(**kw)
    scale = np.abs(c.raw_input_d).max()
    np.testing.assert_allclose(g.raw_input_d, c.raw_input_d, rtol=0,
                               atol=1e-9 * scale)
