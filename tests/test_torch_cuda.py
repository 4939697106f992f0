"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. This file imports
no jax, so it also runs where only torch is installed; the repository's
tests/conftest.py imports jax, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float64 to 1e-10 of the largest value (atomic sums in another
order); float32 paint (K10, K11, K12, K13) per pixel to the relative
tolerance of ops.paint.float32_tolerance (1e-4 for the tile-local
geometry of K10 and K12; K13's unit vectors with their own reach and both
curves' slopes), pixels painted on one side only allowed at disc edges
alone, and K11's float32 map of float64 curves per pixel to 1e-4 (float32
sums in another order); float32 grid offsets (K15) and maps (K16) to
1e-5 of the largest value (float32 sums in another order); K14 to 1e-15
(the same operations); K8 (FFTLog) to 1e-11 of each row's largest value (its FFTs
against torch.fft's: two correct summation orders differ by up to ~4e-12
of it on wide grids), K9 (table rows) to 1e-12 with equal NaN masks;
float32 deposits to the JAX package's edge-jitter bounds
(tests/test_tiled_deposit.py:61-63); float32 regrids to the float32
weight noise, 1e-6 * nside of the largest source value. The tile layouts
(K7), the hot-tile test (K5) and the source list's integers (K6) must be
equal, and so must the stencil (K5: the same operations in the same
order as its plain version) and K13's per-ring pixel angles and pix2ang's;
K6's angles agree to a few ulps (the device's asin against torch's).
K15 bitwise equal from call to call (no atomics).
K17 (snapshot displacement) float64 to 1e-10 of the largest offset, float32
to tests/test_snapshot.py:67 (atol 5e-4, rtol 1e-3); K18 (ring modes)
within ops.sht.ring_modes_tolerance, the plain version's angle rounding;
K19 (Legendre transform) to 4 n_ring eps of its absolute sum (the sums over
rings in another order).
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
from baryonforge_torch.ops import paint                     # noqa: E402
from baryonforge_torch.ops import healpix as hpx            # noqa: E402
from baryonforge_torch.ops import tiles as tt               # noqa: E402

pytestmark = pytest.mark.cuda

TABLE = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                     "_northstar_table.npz")
TSZ_TABLE = os.path.join(os.path.dirname(__file__), "data",
                         "tsz_bench_table.npz")
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


def _wide_discs(halos, curves, r0, dl, nside):
    """Give a few halos discs of 1-8 degrees (the whole-block route of K2,
    the widest over two chunks of rings): at each pole, across phi = 0 and
    in the belt, with Rcom and rscale set so that the curve lookup spans
    the table across each disc (every member moves)."""
    pix = np.pi / (2 * nside)
    for i, th, ph, deg in ((0, None, None, 2.0), (1, None, None, 1.5),
                           (3, 1.2, 0.3 * pix, 1.2),
                           (4, 1.6, 2 * np.pi - 0.6 * pix, 8.0),
                           (5, 0.9, 4.0, 3.0)):
        if th is not None:
            halos["theta"][i] = th
            halos["phi"][i] = ph
        rad = np.radians(deg)
        halos["radius"][i] = rad
        halos["Rcom"][i] = 1e30
        r_max = 2 * np.sin(rad / 2) * (halos["D"][i] / halos["a"][i]).item()
        halos["rscale"][i] = np.exp(r0 + dl * (curves.shape[1] - 2)) / r_max


def _disc_cases(halos, nside):
    """Discs across phi = 0 from either side (halos 6, 7), under 4 members
    (8, 9) and through each pole (10, 11), on top of _inputs' halos at the
    poles and at the table's lowest masses."""
    pix = np.pi / (2 * nside)
    for i, th, ph, rad in ((6, None, 0.2 * pix, None),
                           (7, None, 2 * np.pi - 0.4 * pix, None),
                           (8, 1.3, 0.7, 0.3 * pix), (9, 2.2, 5.1, 0.6 * pix),
                           (10, 0.2 * pix, 1.0, 2.5 * pix),
                           (11, np.pi - 0.3 * pix, 3.0, 3.0 * pix)):
        if th is not None:
            halos["theta"][i] = th
        halos["phi"][i] = ph
        if rad is not None:
            halos["radius"][i] = rad


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside,n,wide", [(64, 300, False),
                                          (256, 400, False),
                                          (1024, 300, True)],
                         ids=["64", "256", "1024-wide"])
def test_disc_deposit_kernel(dev, dt, nside, n, wide):
    _, _, _, halos, curves, r0, dl = _prep(nside, n, dt, dev)
    _disc_cases(halos, nside)
    if wide:
        _wide_discs(halos, curves, r0, dl, nside)
    counts = torch.bincount(deposit.disc_members_plain(
        nside, halos, dt)[0], minlength=n)
    assert (counts < 4).any() and (counts >= 4).any()
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


def _regrid_offsets(nside, case, pdt, dev, seed=23):
    """Offsets of ~0.7 pixel on about half of the pixels (``mixed``) or on
    every pixel (``moved``), or the pixels of the first and last (up to)
    3 rings pushed through the poles and the rest unmoved (``pole``), and
    a map, from a seed."""
    rng = np.random.default_rng(seed)
    npix = 12 * nside * nside
    orig = rng.exponential(1.0, npix)
    if case == "pole":
        theta = hpx.pix2ang(nside, torch.arange(npix, dtype=torch.int32))[0]
        theta = theta.numpy()
        po = np.zeros((npix, 2))
        r = min(3, nside)
        north = np.arange(npix) < 2 * r * (r + 1)
        south = np.arange(npix) >= npix - 2 * r * (r + 1)
        po[north, 0] = -theta[north] * rng.uniform(1.2, 2.5, north.sum())
        po[south, 0] = (np.pi - theta[south]) * rng.uniform(1.2, 2.5,
                                                           south.sum())
        po[north | south, 1] = rng.normal(0, 1e-3, (north | south).sum())
    else:
        po = rng.normal(0, 0.7 / nside, (npix, 2))
        if case == "mixed":
            po[rng.uniform(size=npix) < 0.5] = 0
    return torch.as_tensor(po, dtype=pdt, device=dev), orig


@pytest.mark.parametrize("pdt", DTYPES, ids=["po32", "po64"])
@pytest.mark.parametrize("rdt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [1, 2, 64, 256])
@pytest.mark.parametrize("case", ["mixed", "moved", "pole"])
def test_regrid_kernel_cases(dev, pdt, rdt, nside, case):
    """K3 against its plain version on all four dtype pairs at NSIDE 1, 2,
    64 and 256, with unmoved and moved pixels mixed, every pixel moved, and
    pole overshoots (the tolerances of test_regrid_kernel); mass kept to
    1e-5; with the pole overshoots (NSIDE 64 and 256), the unmoved pixels
    of |z| < 1/2, which no moved source reaches, keep their values bit for
    bit."""
    po, orig64 = _regrid_offsets(nside, case, pdt, dev)
    orig = torch.as_tensor(orig64, device=dev).to(rdt)
    _build.reset_launches()
    ok = regrid.regrid(nside, po, orig)
    assert _build.launches["regrid"] == 1
    op = regrid.regrid_plain(nside, po, orig)
    if rdt == torch.float64:
        atol = 1e-9 * (op - orig).abs().max().item()
    else:
        atol = 1e-6 * nside * orig.abs().max().item()
    torch.testing.assert_close(ok, op, rtol=0, atol=atol)
    assert abs(ok.double().sum().item() / orig64.sum() - 1) < 1e-5
    if case == "pole" and nside >= 64:
        theta = hpx.pix2ang(nside, torch.arange(
            orig.numel(), dtype=torch.int32, device=dev))[0]
        belt = torch.cos(theta).abs() < 0.5
        assert belt.any() and (po[belt] == 0).all()
        assert torch.equal(ok[belt], orig[belt])


@pytest.mark.parametrize("pdt", DTYPES, ids=["po32", "po64"])
@pytest.mark.parametrize("rdt", DTYPES, ids=DT_IDS)
def test_regrid_kernel_unmoved_is_exact(dev, pdt, rdt):
    """Every offset zero: K3 gives the map back bit for bit (-0.0, NaN and
    infinities included), with no atomic."""
    nside = 64
    rng = np.random.default_rng(4)
    orig = torch.as_tensor(rng.normal(size=12 * nside * nside),
                           device=dev).to(rdt)
    orig[:4] = torch.tensor([-0.0, float("nan"), float("inf"), -1e-30])
    po = torch.zeros((orig.numel(), 2), dtype=pdt, device=dev)
    po[5:9] = -0.0
    ok = regrid.regrid(nside, po, orig)
    bits = torch.int32 if rdt == torch.float32 else torch.int64
    assert torch.equal(ok.view(bits), orig.view(bits))


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [1, 2, 64, 1024])
def test_regrid_ring_angles_are_pix2ang(dev, dt, nside):
    """K3 takes each pixel's theta and sin from its ring's row of the ring
    table that its init launch leaves at the head of its scratch, and its
    phi from ring_pixel_phi (K13's, held to pix2ang's bit for bit by
    test_ring_angles_are_pix2ang). After a regrid call, each row's theta
    equals pix2ang's on the card for every pixel of the ring, bit for bit;
    its phi step is 2 pi / nr rounded once from float64, bit for bit; its
    sin is torch.sin's to an ulp, 1 where that is not above 1e-12."""
    npx = 12 * nside * nside
    rng = np.random.default_rng(nside)
    po = torch.as_tensor(rng.normal(0, 0.5 / nside, (npx, 2)), dtype=dt,
                         device=dev)
    orig = torch.ones(npx, dtype=dt, device=dev)
    scratch = regrid._scratch(nside, dt, dev)
    out = torch.empty_like(orig)
    _build.reset_launches()
    regrid._launch(nside, po, orig, scratch, out)
    assert _build.launches["regrid"] == 1
    rows = scratch[:4 * nside * 4 * orig.element_size()].view(dt)
    rows = rows.view(4 * nside, 4)[1:]
    _, nr, _, _ = hpx.ring_info(nside, torch.arange(1, 4 * nside,
                                                    dtype=torch.int32))
    ring = torch.repeat_interleave(torch.arange(4 * nside - 1),
                                   nr.long()).to(dev)
    tp, _ = paint.pixel_angles(nside, dt, dev, per_ring=False)
    assert torch.equal(rows[ring, 0], tp)
    _, dphi, _ = regrid.ring_table_plain(nside, dt)
    assert torch.equal(rows[:, 1].cpu(), dphi)
    s = torch.sin(rows[:, 0])
    sin_safe = torch.where(s > 1e-12, s, torch.ones_like(s))
    eps = torch.finfo(dt).eps
    assert ((rows[:, 2] - sin_safe).abs() <= eps * sin_safe).all()


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


@pytest.mark.parametrize("n_p", [0, 1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("a_kind", ["per_halo", "scalar", "device"])
def test_collapse_curves_kernel_cases(dev, dt, n_p, a_kind):
    """K1 against its plain version for 0 to 6 parameter axes (5 and 6:
    the wide kernel, its corners in groups, counted apart), with a per halo (host), one
    scalar a, and a and M on the card; every axis has halos below and
    above it, which get ``fill``; 0 and 1 halos; one launch a call."""
    rng = np.random.default_rng(40 + n_p)
    shape = (5, 7, 16) + (4, 3, 2, 3, 2, 3)[:n_p]
    axes = tuple(torch.as_tensor(np.cumsum(rng.uniform(0.2, 1.0, k)),
                                 dtype=dt, device=dev) for k in shape)
    table = torch.as_tensor(rng.normal(size=shape), dtype=dt, device=dev)
    n = 300
    lo = [ax[0].item() for ax in axes]
    hi = [ax[-1].item() for ax in axes]
    M = np.exp(rng.uniform(lo[1], hi[1], n))
    a = 1.0 / np.exp(rng.uniform(lo[0], hi[0], n))
    p = {f"p{k}": rng.uniform(lo[3 + k], hi[3 + k], n) for k in range(n_p)}
    # a halo below and one above each axis
    M[:2] = np.exp([lo[1] - 0.1, hi[1] + 0.1])
    if a_kind != "scalar":
        a[2:4] = 1.0 / np.exp([lo[0] - 0.1, hi[0] + 0.1])
    for k in range(n_p):
        p[f"p{k}"][4 + 2 * k:6 + 2 * k] = [lo[3 + k] - 0.1, hi[3 + k] + 0.1]
    if a_kind == "scalar":
        a = float(a[10])
    elif a_kind == "device":
        a = torch.as_tensor(a, dtype=dt, device=dev)
        M = torch.as_tensor(M, dtype=dt, device=dev)
    keys = sorted(p)
    kernel = "collapse_curves_wide" if n_p > 4 else "collapse_curves"
    rel = 1e-6 if dt == torch.float32 else 1e-12
    full = None
    for m in (slice(None), slice(0, 1), slice(0, 0)):
        Mm = M[m]
        am = a if a_kind == "scalar" else a[m]
        pm = {k: v[m] for k, v in p.items()}
        args = (table, axes, 2, Mm, am, keys, pm)
        _build.reset_launches()
        ck, r0, dl = interp.collapse_curves(*args, fill=-3.0)
        assert _build.launches[kernel] == (1 if len(Mm) else 0)
        assert sum(_build.launches.values()) == (1 if len(Mm) else 0)
        cp, rp, dp = interp.collapse_curves_plain(*args, fill=-3.0)
        assert ck.shape == cp.shape and (r0, dl) == (float(rp), float(dp))
        if len(Mm):
            torch.testing.assert_close(ck, cp, rtol=rel,
                                       atol=rel * cp.abs().max().item())
        full = cp if full is None else full
    out_rows = (full == -3.0).all(1)
    assert out_rows[:2].all() and (~out_rows).sum() > n // 2
    if a_kind != "scalar":
        assert out_rows[2:4].all()
    for k in range(n_p):
        assert out_rows[4 + 2 * k:6 + 2 * k].all()


def test_collapse_curves_kernel_guard(dev):
    """The n_h x n_r < 2^31 guard of K1's int32 index math raises before
    anything is allocated or launched."""
    table = torch.zeros((2, 2, 1 << 16), dtype=torch.float32, device=dev)
    axes = tuple(torch.arange(k, dtype=torch.float32, device=dev) + 1.0
                 for k in table.shape)
    _build.reset_launches()
    with pytest.raises(ValueError, match="2\\^31"):
        interp.collapse_curves(table, axes, 2, np.ones(1 << 15), 0.5, [], {})
    assert not _build.launches


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


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _tile_deposit_poisoned(tiling, csr, pack, r0, inv):
    """K4 into an accumulator that held NaN: a block of NaN is freed just
    before the wrapper's torch.empty of the same size takes it (asserted),
    so a slot the kernel does not write shows."""
    junk = torch.full((tiling.n_tiles, tiling.P, 2), float("nan"),
                      dtype=pack["curves"].dtype,
                      device=pack["curves"].device)
    where = junk.data_ptr()
    del junk
    acc = tile_deposit.tile_deposit(tiling, csr, pack, r0, inv)
    assert acc.data_ptr() == where
    return acc


def _hold_tile_deposit(tiling, csr, ak, ap):
    """K4 against its plain version (float64 to 1e-10 of the largest
    offset, float32 to the JAX edge-jitter bounds), with untouched tiles
    and dead slots exact zeros."""
    scale = ap.abs().max().item()
    assert scale > 0
    if ak.dtype == torch.float64:
        torch.testing.assert_close(ak, ap, rtol=0, atol=1e-10 * scale)
    else:
        torch.testing.assert_close(ak, ap, rtol=0, atol=0.02 * scale)
        assert (ak - ap).abs().sum() < 3e-3 * ap.abs().sum()
    untouched = torch.ones(tiling.n_tiles, dtype=torch.bool, device=ak.device)
    untouched[csr[0].long()] = False
    assert untouched.any() and (ak[untouched] == 0).all()
    valid = tile_deposit.slot_geometry_plain(
        tiling, torch.arange(tiling.n_tiles, device=ak.device),
        ak.dtype)[1].reshape(tiling.n_tiles, tiling.P)
    assert (~valid).any() and (ak[~valid] == 0).all()


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside,eps", [(64, 60), (256, 20)])
def test_tile_deposit_kernel(dev, dt, nside, eps):
    """K4 against its plain version; every slot written (the accumulator
    comes from torch.empty), two launches bitwise equal. The catalog's
    halos at dec +-89.5 touch tiles with rows off the sphere."""
    _, _, tiling, csr, pack, r0, inv = _tiled(nside, eps, dt, dev)
    assert csr[0].numel() > 0
    ok = tile_deposit.row_geometry_plain(tiling, csr[0].long())["ok"]
    assert (~ok).any()
    _build.reset_launches()
    ak = _tile_deposit_poisoned(tiling, csr, pack, r0, inv)
    assert _build.launches["tile_deposit"] == 1
    ak2 = tile_deposit.tile_deposit(tiling, csr, pack, r0, inv)
    assert torch.equal(_bits(ak), _bits(ak2))
    ap = tile_deposit.tile_deposit_plain(tiling, csr, pack, r0, inv)
    _hold_tile_deposit(tiling, csr, ak, ap)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_tile_deposit_kernel_chunks(dev, dt):
    """Tiles whose lists hold 0, 1, 16, 17, 64 and 65 halos: the kernel
    stages 16 halos a chunk at these curves (64 radii), so the lists take
    0 to 5 chunks, 17 and 65 one halo into their last. Each list is a
    touched tile's own halos repeated in turn; the 65 go to a polar tile
    with rows off the sphere."""
    _, _, tiling, csr, pack, r0, inv = _tiled(64, 60, dt, dev)
    assert pack["curves"].shape[1] == 64
    tiles, offsets, halos = (x.cpu() for x in csr)
    counts = offsets[1:] - offsets[:-1]
    # touched tiles whose own halos move some slot
    moves = (tile_deposit.tile_deposit_plain(tiling, csr, pack, r0, inv)
             != 0).any(2).any(1).cpu()[tiles.long()]
    off_sphere = ~tile_deposit.row_geometry_plain(
        tiling, tiles.long())["ok"].all(1)
    polar = int(torch.nonzero(off_sphere & moves)[0, 0])
    rest = [int(k) for k in torch.argsort(counts, descending=True)
            if int(k) != polar and moves[k]][:5]
    picks = sorted(zip([polar] + rest, (65, 0, 1, 16, 17, 64)),
                   key=lambda kn: int(tiles[kn[0]]))
    lists = []
    for k, n in picks:
        own = halos[offsets[k]:offsets[k + 1]]
        lists.append(own.repeat(-(-n // own.numel()))[:n])
    sizes = torch.tensor([0] + [x.numel() for x in lists])
    csr2 = tuple(x.to(torch.int32).to(dev) for x in (
        tiles[[k for k, _ in picks]], torch.cumsum(sizes, 0),
        torch.cat(lists)))
    _build.reset_launches()
    ak = _tile_deposit_poisoned(tiling, csr2, pack, r0, inv)
    assert _build.launches["tile_deposit"] == 1
    ap = tile_deposit.tile_deposit_plain(tiling, csr2, pack, r0, inv)
    _hold_tile_deposit(tiling, csr2, ak, ap)
    moved = (ap != 0).any(2).any(1).cpu()[csr2[0].long().cpu()]
    assert [m for m, (_, n) in zip(moved.tolist(), picks) if n != 1] == [
        n > 1 for _, n in picks if n != 1]


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape", [(16, 32), (8, 16)], ids=["shell", "paint"])
@pytest.mark.parametrize("nside", [64, 256, 1024])
def test_tile_layout_kernel(dev, dt, nside, shape):
    tiling = tt.SkyTiling(nside, *shape)
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
@pytest.mark.parametrize("nside,eps", [(64, 60), (256, 20), (1024, 20)])
def test_stencil_kernels(dev, pdt, rdt, nside, eps):
    """K5 (hot test, stencil) and K6 (source list, complement) against
    their plain versions on the tile deposit's offsets, with the polar
    rings pushed through the poles and two tiles made hot. The stencil
    is bitwise the plain version's (the same operations in the same order,
    the ring data from the same table); a float64 regrid takes more than
    48 KB of shared memory a block. The hot test also on offsets that are
    not 16-byte aligned (its scalar route)."""
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
    assert torch.equal(ok, op)
    smem = _build.library().bf_stencil_smem_bytes(
        tiling.RB, tiling.K, tables["W"], tables["Wc"],
        rdt == torch.float64)
    assert (smem > 48 * 1024) == (rdt == torch.float64)
    gk = stencil.stencil_geo(tiling, tables, rdt)
    gp = stencil.stencil_geo_plain(tiling, tables, rdt)
    for a, b in zip(gk[:2], gp[:2]):
        assert torch.equal(a, b)
    for a, b in zip(gk[2:], gp[2:]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=16 * torch.finfo(rdt).eps)
    base = tiling.flat_view(op)
    assert gk[2].shape == (8 * nside, 4) and gk[2].dtype == rdt
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
    # the hot test's scalar route: the same offsets one element further on
    buf = torch.empty(acc.numel() + 1, dtype=acc.dtype, device=dev)
    shifted = buf[1:].view(acc.shape)
    shifted.copy_(acc)
    assert torch.equal(stencil.hot_tiles(shifted, tables), ep)


@pytest.mark.parametrize("pdt", DTYPES, ids=["po32", "po64"])
@pytest.mark.parametrize("rdt", DTYPES, ids=DT_IDS)
def test_stencil_complement_unmoved_is_exact(dev, pdt, rdt):
    """Every offset zero: K6's complement adds each source's value to its
    own pixel by a plain add, no atomic, so the map it returns is the
    input map plus the sources' values bit for bit (-0.0, NaN and
    infinities included), for the geometric list and for tiles listed as
    hot (NSIDE 256, the belt's first tiles outside D_geom)."""
    nside = 256
    tiling = tt.SkyTiling(nside)
    tables = stencil.stencil_tables(tiling, tt.stencil_host_info(tiling),
                                    dev)
    rng = np.random.default_rng(6)
    geo = stencil.stencil_geo(tiling, tables, rdt)
    og = torch.as_tensor(rng.normal(size=(tiling.n_tiles, tiling.P)),
                         device=dev).to(rdt)
    og.view(-1)[geo[0][:4].long()] = torch.tensor(
        [-0.0, float("nan"), float("inf"), 1e-30], dtype=rdt, device=dev)
    base = torch.as_tensor(rng.normal(size=tiling.npix), device=dev).to(rdt)
    acc = torch.zeros((tiling.n_tiles, tiling.P, 2), dtype=pdt, device=dev)
    acc[:, 5:9] = -0.0
    hot = torch.nonzero(~tables["D_geom"])[:6, 0].to(torch.int32)
    _build.reset_launches()
    got = stencil.stencil_complement(tiling, base.clone(), acc, og, geo, hot)
    assert _build.launches["stencil_complement"] == 1
    # each source's value added to its own pixel, one add each
    arr = tiling.device_arrays(dev)
    h = hot.long()
    hpix, valid = tiling.slot_pix(arr["tile_i0"][h], arr["tile_s"][h],
                                  arr["tile_S"][h])
    hslot = (h[:, None] * tiling.P
             + torch.arange(tiling.P, device=dev)).reshape(-1)
    slot = torch.cat([geo[0].long(), hslot[valid.reshape(-1)]])
    pix = torch.cat([geo[1].long(),
                     hpix.reshape(-1)[valid.reshape(-1)].long()])
    assert pix.unique().numel() == pix.numel()
    want = base.clone()
    want[pix] = base[pix] + og.view(-1)[slot]
    bits = torch.int32 if rdt == torch.float32 else torch.int64
    assert torch.equal(got.view(bits), want.view(bits))
    assert not torch.equal(got.view(bits), base.view(bits))


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [64, 256, 1024])
def test_stencil_ring_table_is_pix2ang(dev, dt, nside):
    """K6's ring table (filled by stencil_geo's blocks past the tiles, by
    healpix.cuh's ring_row and source_ring_row, shared with K3): the
    target form's theta equals pix2ang's on the card for every pixel of
    the ring, the source form's the float64 pix2ang's rounded to the
    dtype, bit for bit; both phi steps 2 pi / nr rounded once from
    float64, bit for bit; each sin torch.sin's of its theta to an ulp, 1
    where that is not above 1e-12; the forms the same in float64."""
    tiling = tt.SkyTiling(nside)
    tables = stencil.stencil_tables(tiling, tt.stencil_host_info(tiling),
                                    dev)
    rows = stencil.stencil_geo(tiling, tables, dt)[2].view(2, 4 * nside, 4)
    _, nr, _, _ = hpx.ring_info(nside, torch.arange(1, 4 * nside,
                                                    dtype=torch.int32))
    ring = torch.repeat_interleave(torch.arange(1, 4 * nside),
                                   nr.long()).to(dev)
    tp, _ = paint.pixel_angles(nside, dt, dev, per_ring=False)
    t64, _ = paint.pixel_angles(nside, torch.float64, dev, per_ring=False)
    assert torch.equal(rows[0, ring, 0], tp)
    assert torch.equal(rows[1, ring, 0], t64.to(dt))
    _, dphi, _ = regrid.ring_table_plain(nside, dt)
    for f in (0, 1):
        assert torch.equal(rows[f, 1:, 1].cpu(), dphi)
        s = torch.sin(rows[f, 1:, 0])
        sin_safe = torch.where(s > 1e-12, s, torch.ones_like(s))
        eps = torch.finfo(dt).eps
        assert ((rows[f, 1:, 2] - sin_safe).abs() <= eps * sin_safe).all()
    assert not rows[:, 0].any() and not rows[..., 3].any()
    if dt == torch.float64:
        assert torch.equal(rows[0], rows[1])


# ---- the table build: K8 FFTLog, K9 table rows -----------------------------
@pytest.mark.parametrize("B,N,mu,q,smem", [
    (1, 1024, 0.5, -0.5, None), (20, 2048, 0.5, -0.5, None),
    (20, 2048, 0.0, -0.5, None), (3, 100, 0.0, -1.0, None),
    (1, 4096, 0.5, -0.5, None), (2, 3000, 0.0, -0.5, None),
    (1, 8192, 0.5, -0.5, None), (2, 12288, 0.5, -0.5, None),
    (20, 1024, 0.0, -0.5, None), (3, 100, 0.0, -1.0, 2048),
    (200, 128, 0.5, -0.5, 2048), (1, 16384, 0.5, -0.5, None),
    (2, 32768, 0.0, -0.5, None), (1, 20000, 0.5, -0.5, None),
    (1, 1 << 21, 0.5, -0.5, None), (1, (1 << 20) - 1, 0.0, -0.5, None),
    (1, 1 << 22, 0.5, -0.5, None), (1, (1 << 20) + 1, 0.0, -0.5, None),
    (1, 1 << 27, 0.5, -0.5, None), (1, (1 << 26) - 1, 0.0, -0.5, None)])
def test_fht_kernel(dev, B, N, mu, q, smem):
    """K8 on correlation_3d's grid (B = 1, N = 1024: the S19 and tSZ table
    builds' only shape), on a Fourier-like batch (B = 20, N = 2048), on
    a Pixel convolution's batch (20 x 1024), on a length that is no power
    of two with q on a Gamma pole, on the longest power of two whose row
    fits shared memory (4096), and on the device-memory route: Bluestein at
    N = 3000, 12288 and 20000, powers of two at 8192, 16384 and 32768,
    rows of an FFT of 2^21 points (a power of two of that length, and
    Bluestein just under half of it) and past it, of 2^22 points (a power
    of two, and Bluestein just over 2^20) and of 2^27 points (a power of
    two, and Bluestein just under 2^26), and the pass route forced at small
    N with 2048 bytes of shared memory (one pass of M points; 200 rows);
    against its plain version, with the launches the plan predicts."""
    rng = np.random.default_rng(N)
    x = torch.as_tensor(np.geomspace(1e-4, 1e4, N), device=dev)
    a = torch.as_tensor(np.exp(-np.geomspace(1e-4, 1e4, N)[None]
                               * rng.uniform(0.5, 2.0, (B, 1))), device=dev)
    lx, ln_kcrc = fftlog._fht_grids(x, 1.0)
    qs = fftlog._safe_q(mu, q)
    _build.reset_launches()
    if smem is None:
        k, ok = fftlog.fht(x, a, mu, q)
        smem = fftlog.shared_memory_optin(dev)
    else:
        k, ok = fftlog._fht_kernel(x, a, mu, qs, ln_kcrc, smem_bytes=smem)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fftlog.fht_plan(N, smem, B, sms)
    assert _build.launches["fht"] == fftlog.fht_launches(plan, B, B)
    # the k grid, written by the kernel
    kp = torch.exp(ln_kcrc - lx[-1] + torch.arange(N, device=dev)
                   * ((lx[-1] - lx[0]) / (N - 1)))
    torch.testing.assert_close(k, kp, rtol=1e-14, atol=0)
    assert plan.in_shared == (N in (100, 1024, 2048, 4096) and smem > 2048)
    op = fftlog.fht_plain(a, lx, mu, qs, ln_kcrc)
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


def rows_inputs(B, n, n_r, seed=5):
    """K9's inputs from a seed, float64 numpy: NFW-like densities of B
    halos on a log grid of n points (1e-4 to 1e3), the DMB ones the DMO
    ones times a smooth factor in (0.6, 1.4), the integrands 2 pi r^2 rho
    dlnr, the grid's logs and n_r output radii's (1e-3 to 60). Row 1 has
    no density past the fourth output radius (at most 5 usable points: a
    broken row), row 2 an infinite integrand half way (the DMO mass not
    finite from there), row 3 a NaN DMB integrand (an all-NaN row)."""
    rng = np.random.default_rng(seed)
    lnr_int = np.linspace(np.log(1e-4), np.log(1e3), n)
    lnr = np.linspace(np.log(1e-3), np.log(60.0), n_r)
    r = np.exp(lnr_int)
    x = r / 10 ** rng.uniform(-1.5, -0.5, (B, 1))
    dens_o = 10 ** rng.uniform(12, 15, (B, 1)) / (x * (1 + x) ** 2)
    dens_b = dens_o * (1 + rng.uniform(0.1, 0.4, (B, 1)) * np.tanh(
        np.log(x) - rng.uniform(-1, 1, (B, 1))))
    dl = lnr_int[1] - lnr_int[0]
    intgd_o = 2 * np.pi * r ** 2 * dens_o * dl
    intgd_b = 2 * np.pi * r ** 2 * dens_b * dl
    if B > 1:
        cut = np.searchsorted(lnr_int, lnr[3]) + 1
        dens_b[1, cut:] = 0.0
        intgd_b[1, cut:] = 0.0
    if B > 2:
        intgd_o[2, n // 2] = np.inf
    if B > 3:
        intgd_b[3] = np.nan
    return intgd_o, dens_o, intgd_b, dens_b, lnr_int, lnr


def test_table_rows_kernel(dev):
    """K9 on the bench table's first redshift (20 masses, 64 radii, 500
    integration points), against its plain versions on the same inputs:
    its halves apart, then the fused launch."""
    m = _bench_model(dev)
    r = np.geomspace(1e-3, 60, 64)
    M = np.geomspace(5e12, 2e15, 20)
    a = 1.0 / 1.7
    r_int = np.geomspace(min(r.min(), m.r_min_int) / 1.2,
                         max(r.max(), m.r_max_int) * 1.2, m.N_int)
    lnr_int = torch.log(torch.as_tensor(r_int, device=dev))
    lnr = torch.log(torch.as_tensor(r, device=dev))
    dl = float(np.log(r_int[1] / r_int[0]))
    masses, ins = [], []
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
        ins.append((intgd, dens))
    dk = table_rows.displacement_rows(lnr, *masses)
    dp = table_rows.displacement_rows_plain(lnr, *masses)
    assert _build.launches["enclosed_mass"] == 2
    assert _build.launches["displacement_rows"] == 1
    _hold_rows(dk, dp)
    fk = table_rows.displacement_table(*ins[0], *ins[1], lnr_int, lnr)
    assert _build.launches["table_rows"] == 1
    _hold_rows(fk, table_rows.displacement_table_plain(*ins[0], *ins[1],
                                                       lnr_int, lnr))


def _hold_rows(dk, dp):
    """K9's displacement rows against the plain version's: the same NaN
    mask, values to 1e-12 of the largest |d|."""
    assert torch.equal(torch.isnan(dk), torch.isnan(dp))
    torch.testing.assert_close(dk, dp, rtol=0, equal_nan=True,
                               atol=1e-12 * dp.nan_to_num().abs().max().item())


@pytest.mark.parametrize("B,n,n_r", [(1, 97, 6), (4, 33, 7), (20, 500, 64),
                                     (6, 129, 256), (9, 500, 100),
                                     (640, 500, 64)])
def test_table_rows_kernel_cases(dev, B, n, n_r):
    """K9's fused launch and its enclosed-mass half against their plain
    versions on rows made from a seed (rows_inputs: a broken row, a mass
    that stops being finite, an all-NaN row): grids of n points not a
    multiple of 32, 6 to 256 radii, 1 to 640 rows (the p-key combinations
    of a parameter table make B large). The masses to 1e-12 relative with
    equal NaN masks; the displacements with the plain version's NaN mask,
    and to 1e-12 of the largest |d| against the plain inversion of the
    kernel's own masses. Against the plain masses' inversion they are not
    held to that: where M_DMB flattens, the inversion moves d by up to
    1.8e-10 for a 1e-15 relative change of the masses (the plain version
    on the CPU, these rows), the size of the change that summing the
    Simpson increments in another order makes."""
    ts = [torch.as_tensor(x, device=dev) for x in rows_inputs(B, n, n_r)]
    io, do, ib, db, lnr_int, lnr = ts
    _build.reset_launches()
    masses = []
    for i, d in ((io, do), (ib, db)):
        ek = table_rows.enclosed_mass(i, d, lnr_int, lnr)
        ep = table_rows.enclosed_mass_plain(i, d, lnr_int, lnr)
        assert torch.equal(torch.isnan(ek), torch.isnan(ep))
        torch.testing.assert_close(ek, ep, rtol=1e-12, atol=0,
                                   equal_nan=True)
        masses.append(ek)
    fk = table_rows.displacement_table(*ts)
    assert _build.launches["table_rows"] == 1
    dp = table_rows.displacement_table_plain(*ts)
    assert torch.equal(torch.isnan(fk), torch.isnan(dp))
    _hold_rows(fk, table_rows.displacement_rows_plain(lnr, *masses))
    if B > 3:
        assert torch.isnan(fk[1]).all() and torch.isnan(fk[3]).all()
    assert torch.isfinite(fk[0]).any()


def test_table_build_cuda_matches_cpu(dev):
    """setup_interpolator on the card (K8, K9) against the plain versions
    on the CPU, 2 z x 4 M x 16 r, to 1e-9 of the largest |d|."""
    kw = dict(z_min=0.7, z_max=1.1, N_samples_z=2, M_min=5e12, M_max=2e15,
              N_samples_Mass=4, R_min=1e-3, R_max=60, N_samples_R=16,
              verbose=False)
    _build.reset_launches()
    g = _bench_model(dev).setup_interpolator(**kw)
    assert _build.launches["fht"] == 2 * 2
    assert _build.launches["table_rows"] == 2
    assert _build.launches["enclosed_mass"] == 0
    assert _build.launches["displacement_rows"] == 0
    c = _bench_model("cpu").setup_interpolator(**kw)
    scale = np.abs(c.raw_input_d).max()
    np.testing.assert_allclose(g.raw_input_d, c.raw_input_d, rtol=0,
                               atol=1e-9 * scale)


# ---- the paint's kernels: K10 tile paint, K11 disc paint -------------------
def _tsz_models():
    """The bench's tSZ table (log curves, tests/data/tsz_bench_table.npz)
    and its raw form (exp of the tables, raw curves)."""
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    log_tab = bf.utils.TabulatedProfile(
        None, cosmo, mass_def=bf.cosmo.MassDef200c).load_table(TSZ_TABLE)
    raw_tab = bf.utils.ParamTabulatedProfile(
        None, cosmo, mass_def=bf.cosmo.MassDef200c)
    raw_tab._set_axes(log_tab._axes, np.exp(log_tab.raw_input_3D),
                      np.exp(log_tab.raw_input_2D))
    return {"log": log_tab, "raw": raw_tab}


def _paint_f32_close(k, p, rtol, marginal):
    """Per pixel |k - p| <= rtol |p| where both paint and the pixel is not
    marginal (ops.paint.float32_tolerance); a pixel painted on one side only
    must be marginal, and marginal pixels are under 1% of the painted."""
    k, p = k.double(), p.double()
    nk, np_ = k != 0, p != 0
    keep = nk & np_ & ~marginal
    assert keep.sum() > 100
    assert ((k - p).abs() <= rtol * p.abs())[keep].all()
    assert not ((nk ^ np_) & ~marginal).any()
    assert (marginal & (nk | np_)).sum() <= 1e-2 * (nk | np_).sum()


def _halos(hd, dev):
    return {k: torch.as_tensor(hd[k], device=dev) for k in paint.HALO_COLUMNS}


def _paint_prep(nside, eps, kind, dt, dev):
    """A paint runner's halo data and curves (K1's plain version) on the
    test catalog."""
    cat, shell = _inputs(nside, 300)
    model = _tsz_models()[kind]
    r = bf.PaintProfilesShell(cat, shell, epsilon_max=eps, model=model,
                              dtype=dt, device=dev)
    hd = r._host_halo_data(bf.cosmo.cosmology_from_dict(r.cosmo))
    m = model.with_dtype(dt, device=dev)
    curves, r0, dl = interp.collapse_curves_plain(
        m._tab2D, m._axes, 2, hd["M"], hd["a"], [], {},
        fill=-np.inf if model.curves_are_log else 0.0)
    return r, hd, curves, float(r0), float(dl), model.curves_are_log


@pytest.mark.parametrize("kind", ["log", "raw"])
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside,eps,shape", [(64, 60, (8, 16)),
                                             (256, 20, (16, 32)),
                                             (256, 5, (8, 16))])
def test_tile_paint_kernel(dev, kind, dt, nside, eps, shape):
    r, hd, curves, r0, dl, log = _paint_prep(nside, eps, kind, dt, dev)
    r._paint_tiling = lambda nside, hd: r._get_tiling(nside, shape)
    tiling, csr, pack = r._tile_paint_inputs(hd, curves, log, nside)
    assert (tiling.RB, tiling.K) == shape
    _build.reset_launches()
    ak = tile_deposit.tile_paint(tiling, csr, pack, r0, 1.0 / dl, log)
    assert _build.launches["tile_paint"] == 1
    ap = tile_deposit.tile_paint_plain(tiling, csr, pack, r0, 1.0 / dl, log)
    assert ak.shape == (tiling.n_tiles, tiling.P)
    if dt == torch.float64:
        torch.testing.assert_close(ak, ap, rtol=0,
                                   atol=1e-10 * ap.abs().max().item())
        assert torch.equal(ak == 0, ap == 0)
    else:
        # tile-local geometry, well conditioned: rtol 1e-4 per pixel
        rtol, marginal = paint.float32_tolerance(nside, _halos(hd, dev),
                                                 curves, r0, dl, log)
        _paint_f32_close(tiling.flat_view_plain(ak),
                         tiling.flat_view_plain(ap),
                         torch.full_like(rtol, 1e-4), marginal)


def _empty_disc(halos, nside, i=12):
    """Give halo i a disc that holds no pixel centre: between two belt
    rings, a twentieth of a pixel wide."""
    rings = torch.tensor([2 * nside, 2 * nside + 1], dtype=torch.int32)
    halos["theta"][i] = hpx.ring_theta(nside, rings).mean().item()
    halos["phi"][i] = 0.0
    halos["radius"][i] = 0.05 * np.pi / (2 * nside)


def _wide_paint_discs(halos, nside, r0, dl, n_r):
    """_wide_anis_discs (1.2-3 degrees, more than SPLIT_RINGS rings at
    NSIDE 1024), with D set so that each disc's edge sits near the curves'
    largest radius (every member paints)."""
    _wide_anis_discs(halos, nside)
    for i in (0, 3, 4):
        rad = halos["radius"][i].item()
        halos["D"][i] = (halos["a"][i].item() * np.exp(r0 + dl * (n_r - 2))
                         / (2 * np.sin(rad / 2)))


@pytest.mark.parametrize("kind", ["log", "raw"])
@pytest.mark.parametrize("dt,acc_dt", [(torch.float32, torch.float64),
                                       (torch.float32, torch.float32),
                                       (torch.float64, torch.float64),
                                       (torch.float64, torch.float32)],
                         ids=["f32_f64", "f32_f32", "f64_f64", "f64_f32"])
@pytest.mark.parametrize("pix", [False, True], ids=["value", "pixel_size"])
@pytest.mark.parametrize("nside,eps", [(64, 60), (256, 20), (1024, 5)])
def test_disc_paint_kernel(dev, kind, dt, acc_dt, pix, nside, eps):
    """K11 against its plain version on the four (curve, map) dtype pairs,
    with discs across phi = 0, under 4 members, through each pole and one
    with no member; at NSIDE 1024 three discs of 1.2-3 degrees run the
    whole-block route. A float64 map to 1e-10 of the largest value, a
    float32 map of float64 curves per pixel to 1e-4 (its sums rounded in
    another order), float32 curves to ops.paint.float32_tolerance."""
    _, hd, curves, r0, dl, log = _paint_prep(nside, eps, kind, dt, dev)
    halos = _halos(hd, dev)
    _disc_cases(halos, nside)
    _empty_disc(halos, nside)
    if nside == 1024:
        _wide_paint_discs(halos, nside, r0, dl, curves.shape[1])
    walk = deposit.disc_walk_plain(nside, halos["theta"], halos["phi"],
                                   halos["radius"], dt)
    assert (~walk["block"]).any() and walk["block"].any() == (nside == 1024)
    members = torch.bincount(walk["halo"][walk["member"]],
                             minlength=curves.shape[0])
    assert members[12] == 0 and (members[10:12] > 0).all()
    _build.reset_launches()
    ak = paint.disc_paint(nside, halos, curves, r0, dl, log, pix, acc_dt)
    assert _build.launches["disc_paint"] == 1 and ak.dtype == acc_dt
    ap = paint.disc_paint_plain(nside, halos, curves, r0, dl, log, pix,
                                acc_dt)
    if dt == torch.float64 and acc_dt == torch.float64:
        torch.testing.assert_close(ak, ap, rtol=0,
                                   atol=1e-10 * ap.abs().max().item())
    elif dt == torch.float64:
        _, marginal = paint.float32_tolerance(nside, halos, curves, r0, dl,
                                              log)
        _paint_f32_close(ak, ap, torch.full_like(marginal, 1e-4,
                                                 dtype=torch.float64),
                         marginal)
    else:
        _paint_f32_close(ak, ap, *paint.float32_tolerance(nside, halos, curves,
                                                          r0, dl, log))


@pytest.mark.parametrize("deposit", ["auto", "scatter"])
def test_paint_shell_cuda_matches_cpu(dev, deposit):
    """PaintProfilesShell on the card (K1, K10 and K7 tiled; K1 and K11
    scatter) against the plain versions on the CPU, float64, rtol 1e-9."""
    cat, shell = _inputs(256, 400)
    kw = dict(epsilon_max=20, model=_tsz_models()["log"], deposit=deposit,
              dtype=torch.float64, include_pixel_size=True)
    _build.reset_launches()
    out_g = bf.PaintProfilesShell(cat, shell, device=dev, **kw).process()
    want = (("collapse_curves", "disc_paint") if deposit == "scatter"
            else ("collapse_curves", "tile_paint", "flat_view"))
    assert all(_build.launches[k] == 1 for k in want), _build.launches
    out_c = bf.PaintProfilesShell(cat, shell, device="cpu", **kw).process()
    assert out_c.max() > 0
    np.testing.assert_allclose(out_g, out_c, rtol=1e-9,
                               atol=1e-12 * out_c.max())


# ---- the anisotropic paint's kernels: K12 paint2, K13, K14 -----------------
def _anis_curves(hd, kinds, dev):
    """The model's and the tracer's curves (K1's plain version on the
    float64 tables, as the runner reads them): one (curves, ln_r0, dlnr,
    log) per kind."""
    out = []
    for kind in kinds:
        model = _tsz_models()[kind]
        m = model.with_dtype(torch.float64, device=dev)
        c, r0, dl = interp.collapse_curves_plain(
            m._tab2D, m._axes, 2, hd["M"], hd["a"], [], {},
            fill=-np.inf if model.curves_are_log else 0.0)
        out.append((c, float(r0), float(dl), model.curves_are_log))
    return out


def _anis_prep(nside, eps, kinds, dt, dev):
    cat, shell = _inputs(nside, 300)
    tab = _tsz_models()["log"]
    r = bf.PaintProfilesAnisShell(cat, shell, epsilon_max=eps, model=tab,
                                  Tracer_model=tab, Mtot_model=tab,
                                  background_val=1.0,
                                  global_tracer_fraction=0.1, dtype=dt,
                                  device=dev)
    hd = r._host_halo_data(bf.cosmo.cosmology_from_dict(r.cosmo))
    return r, shell, hd, _anis_curves(hd, kinds, dev)


@pytest.mark.parametrize("kinds", [("log", "log"), ("raw", "raw"),
                                   ("log", "raw")],
                         ids=["log-log", "raw-raw", "log-raw"])
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside,eps", [(64, 60), (256, 5)])
def test_tile_paint2_kernel(dev, kinds, dt, nside, eps):
    """K12 against its plain version on the runner's own pack: float64 to
    1e-10 of the largest value with equal zeros, float32 per pixel to 1e-4
    (K10's tile-local geometry) away from disc edges and table ends."""
    r, _, hd, curves = _anis_prep(nside, eps, kinds, dt, dev)
    tiling, csr, pack, grid = r._tile_paint2_inputs(hd, curves, nside)
    _build.reset_launches()
    ak = tile_deposit.tile_paint2(tiling, csr, pack, *grid)
    assert _build.launches["tile_paint2"] == 1
    ap = tile_deposit.tile_paint2_plain(tiling, csr, pack, *grid)
    assert ap.abs().max() > 0
    if dt == torch.float64:
        torch.testing.assert_close(ak, ap, rtol=0,
                                   atol=1e-10 * ap.abs().max().item())
        assert torch.equal(ak == 0, ap == 0)
    else:
        (c1, r1, d1, l1), (c2, r2, d2, l2) = curves
        _, marginal = paint.float32_tolerance(
            nside, _halos(hd, dev), c1, r1, d1, l1,
            second=(c2, r2, d2, l2))
        _paint_f32_close(tiling.flat_view_plain(ak),
                         tiling.flat_view_plain(ap),
                         torch.full_like(marginal, 1e-4, dtype=torch.float64),
                         marginal)


def _wide_anis_discs(halos, nside):
    """Give a few halos discs of 1-3 degrees, more than SPLIT_RINGS rings
    at NSIDE 1024 (K13's whole-block route): at a pole, across phi = 0
    and in the belt."""
    pix = np.pi / (2 * nside)
    for i, th, ph, deg in ((0, None, None, 1.5), (3, 1.2, 0.3 * pix, 1.2),
                           (4, 1.6, 2 * np.pi - 0.6 * pix, 3.0)):
        if th is not None:
            halos["theta"][i] = th
            halos["phi"][i] = ph
        halos["radius"][i] = np.radians(deg)


@pytest.mark.parametrize("kinds", [("log", "log"), ("raw", "log")],
                         ids=["log-log", "raw-log"])
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("pix", [False, True], ids=["value", "pixel_size"])
@pytest.mark.parametrize("nside,eps", [(64, 60), (256, 20), (1024, 5)])
def test_disc_paint_anis_kernel(dev, kinds, dt, pix, nside, eps):
    """K13 against its plain version: float64 to 1e-10 of the largest
    value (atomic sums in another order), float32 per pixel to
    ops.paint.float32_tolerance with the unit vectors' reach and both
    curves' slopes. At NSIDE 1024 the bench's epsilon_max 5 gives discs of
    a few rings (a warp each) and three discs of 1.2-3 degrees run the
    whole-block route."""
    _, shell, hd, curves = _anis_prep(nside, eps, kinds, dt, dev)
    halos = _halos(hd, dev)
    if nside == 1024:
        _wide_anis_discs(halos, nside)
    block = deposit.disc_walk_plain(nside, halos["theta"], halos["phi"],
                                    halos["radius"], dt)["block"]
    assert (~block).any()
    assert block.any() == (nside == 1024)
    g = torch.Generator(device=dev).manual_seed(5)
    npix = 12 * nside * nside
    mtot = torch.rand(npix, dtype=torch.float64, device=dev, generator=g)
    mtot[::7] = 0.0
    orig = torch.as_tensor(shell.map, device=dev)
    painting, canvas = ((c.to(dt),) + tuple(rest) for c, *rest in curves)
    _build.reset_launches()
    ak = paint.disc_paint_anis(nside, halos, painting, canvas, mtot, orig, pix)
    assert _build.launches["disc_paint_anis"] == 1
    ap = paint.disc_paint_anis_plain(nside, halos, painting, canvas, mtot,
                                     orig, pix)
    assert ak.dtype == torch.float64 and ap.abs().max() > 0
    if dt == torch.float64:
        torch.testing.assert_close(ak, ap, rtol=0,
                                   atol=1e-10 * ap.abs().max().item())
    else:
        (c1, r1, d1, l1), (c2, r2, d2, l2) = curves
        _paint_f32_close(ak, ap, *paint.float32_tolerance(
            nside, halos, c1, r1, d1, l1, reach=paint.VEC_SINHD_REACH,
            second=(c2, r2, d2, l2)))


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [64, 256, 1024])
def test_ring_angles_are_pix2ang(dev, dt, nside):
    """K13 takes a pixel's theta (so sin and cos theta) from its ring
    (ring_theta) and its phi from pix2ang's formula on the ring and index:
    on the card both equal pix2ang's, bit for bit, for every pixel."""
    _build.reset_launches()
    tr, pr = paint.pixel_angles(nside, dt, dev, per_ring=True)
    tp, pp = paint.pixel_angles(nside, dt, dev, per_ring=False)
    assert _build.launches["pixel_angles"] == 2
    assert torch.equal(tr, tp) and torch.equal(pr, pp)
    # and the card's pix2ang is the plain version's to a few ulps
    tc, pc = paint.pixel_angles_plain(nside, dt, False)
    eps = torch.finfo(dt).eps
    assert ((tp.cpu() - tc).abs() <= 8 * eps * tc.abs()).all()
    assert ((pp.cpu() - pc).abs() <= 8 * eps * pc.abs()).all()


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "summed"])
def test_anis_finish_kernel(dev, dt, tiled):
    """K14 against its plain version: the same operations in the same
    order, to 1e-15 relative."""
    g = torch.Generator(device=dev).manual_seed(7)
    n = 100_003
    hs = torch.rand(n, dtype=torch.float64, device=dev, generator=g).to(dt)
    mt = (torch.rand(n, dtype=torch.float64, device=dev, generator=g)
          - 0.1).to(dt)
    og = torch.rand(n, dtype=torch.float64, device=dev, generator=g)
    _build.reset_launches()
    ok = paint.anis_finish(hs, mt, og, 0.05, 0.1, 4.0, tiled)
    assert _build.launches["anis_finish"] == 1
    op = paint.anis_finish_plain(hs, mt, og, 0.05, 0.1, 4.0, tiled)
    torch.testing.assert_close(ok, op, rtol=1e-15, atol=0)


def _dm_table(dev):
    """TabulatedProfile(DarkMatter(**bpar, proj_cutoff=100)) built on
    ``dev`` on a small grid around z = 0.9: a mass model whose halo sum
    dominates the anisotropic paint (tests/test_runners_extra.py:19-32)."""
    h = 0.7
    bpar = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / h, mu_beta=0.4,
                eta=0.3, eta_delta=0.3, tau=-1.5, tau_delta=0,
                A=0.09 / 2, M1=2.5e11 / h, epsilon_h=0.015,
                a=0.3, n=2, epsilon=4, p=0.3, q=0.707, gamma=2, delta=7)
    return bf.utils.TabulatedProfile(
        bf.Profiles.DarkMatter(**bpar, proj_cutoff=100),
        bf.cosmo.cosmology_from_dict(COSMO), device=dev).setup_interpolator(
        z_min=0.7, z_max=1.1, N_samples_z=3, M_min=1e13, M_max=3e15,
        N_samples_Mass=6, R_min=1e-3, R_max=60, N_samples_R=48,
        verbose=False)


def test_anis_shell_cuda_matches_cpu(dev):
    """PaintProfilesAnisShell on the card (tiled: K1, K10, K7, K12, K14;
    scatter: K1, K11, K13, K14) against the plain versions on the CPU,
    float64, to 1e-9 of the largest value."""
    cat, shell = _inputs(256, 400)
    shell.redshift = 0.9
    tab = _dm_table(dev)
    for deposit in ("auto", "scatter"):
        kw = dict(epsilon_max=20, model=tab, Tracer_model=tab,
                  Mtot_model=tab, background_val=1.0,
                  global_tracer_fraction=0.1, dtype=torch.float64,
                  deposit=deposit)
        _build.reset_launches()
        out_g = bf.PaintProfilesAnisShell(cat, shell, device=dev,
                                          **kw).process()
        want = (("collapse_curves", "disc_paint", "disc_paint_anis",
                 "anis_finish") if deposit == "scatter" else
                ("collapse_curves", "tile_paint", "tile_paint2", "flat_view",
                 "anis_finish"))
        assert all(_build.launches[k] >= 1 for k in want), _build.launches
        out_c = bf.PaintProfilesAnisShell(cat, shell, device="cpu",
                                          **kw).process()
        np.testing.assert_allclose(out_g, out_c, rtol=0,
                                   atol=1e-9 * np.abs(out_c).max())


# ---- the grid runners' kernels: K15 cutouts, K16 deposit -------------------
@pytest.mark.parametrize("pdt,rdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.float64),
                                     (torch.float64, torch.float64)],
                         ids=["f32-f32", "f32-f64", "f64-f64"])
@pytest.mark.parametrize("ndim,npix,reach", [
    (2, 128, 3.0), (3, 32, 3.0), (2, 100, 0.999), (3, 33, 0.999),
    (2, 24, 5.0), (3, 24, 5.0)])
def test_grid_deposit_kernel(dev, pdt, rdt, ndim, npix, reach):
    """K16 against its plain version, offsets within +-reach cells (some
    non-finite; a fifth exactly 0) across the periodic edges: float64 to
    1e-12 of the largest value, float32 to 1e-5 of it (sums of 2^d terms
    in another order); mass to 1e-12 or 1e-5. Grids of 128^2 and 32^3 are
    whole tiles, 100^2 and 33^3 are not, and 24 is less than a 2D tile's
    rows and a 3D tile's row (the window wraps onto itself); reach 0.999
    keeps every corner in its tile's window, 3 and 5 spill. The kernel's
    tile is ops.scatter.TILE."""
    from baryonforge_torch.ops import scatter
    lib = _build.library()
    assert tuple(lib.bf_grid_deposit_tile(ndim, d)
                 for d in range(ndim)) == scatter.TILE[ndim]
    g = torch.Generator(device=dev).manual_seed(9)
    nflat = npix ** ndim
    po = ((torch.rand((ndim, nflat), dtype=torch.float64, device=dev,
                      generator=g) * 2 - 1) * reach).to(pdt)
    po[:, ::5] = 0
    po[0, ::97] = float("nan")
    po[ndim - 1, ::89] = float("inf")
    orig = torch.rand(nflat, dtype=torch.float64, device=dev,
                      generator=g).to(rdt)
    _build.reset_launches()
    ok = scatter.grid_deposit(po, orig, npix, ndim)
    assert _build.launches["grid_deposit"] == 1
    op = scatter.grid_deposit_plain(po, orig, npix, ndim)
    counts = {}
    ow = scatter.grid_deposit_windows_plain(po, orig, npix, ndim,
                                            counts=counts)
    assert (counts["spilled"] > 0) == (reach > 1)
    rel = 1e-12 if rdt == torch.float64 else 1e-5
    for want in (op, ow):
        torch.testing.assert_close(ok, want, rtol=0,
                                   atol=rel * op.abs().max().item())
    assert abs(ok.double().sum().item() / orig.double().sum().item()
               - 1) < rel


@pytest.mark.parametrize("ndim,npix", [(2, 40), (3, 20)])
def test_grid_deposit_kernel_non_finite(dev, ndim, npix):
    """K16 with an inf and a NaN in the map's values, one source moved by
    exactly 0 (a zero weight times inf is NaN: kept) and one by half a
    cell: the same non-finite cells as the plain version, the finite cells
    to 1e-12 of the largest."""
    from baryonforge_torch.ops import scatter
    nflat = npix ** ndim
    rng = np.random.default_rng(ndim)
    po = torch.as_tensor(rng.uniform(-0.6, 0.6, (ndim, nflat)), device=dev)
    orig = torch.as_tensor(rng.uniform(0, 1, nflat), device=dev)
    po[:, 7] = 0.0
    po[:, 300] = 0.5
    orig[7] = float("inf")
    orig[300] = float("nan")
    ok = scatter.grid_deposit(po, orig, npix, ndim)
    op = scatter.grid_deposit_plain(po, orig, npix, ndim)
    assert torch.equal(torch.isnan(ok), torch.isnan(op))
    assert torch.equal(torch.isinf(ok), torch.isinf(op))
    fin = torch.isfinite(op)
    assert int((~fin).sum()) > 1
    torch.testing.assert_close(ok[fin], op[fin], rtol=0,
                               atol=1e-12 * op[fin].abs().max().item())


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("ndim,N,M", [(2, 256, 100_000), (3, 64, 200_000),
                                      (2, 33, 5000), (3, 5, 3000)])
def test_deposit_list_kernel(dev, dt, ndim, N, M):
    """The public deposit_2d / deposit_3d on the card: the list entry of
    K16, one launch a call, against the plain version on the card
    (index_add_), positions in [-N/4, 5N/4) with a tenth exact integers
    and -N, N, a tiny negative value and 0 among them, on a random grid:
    float64 to 1e-12 of the largest value, float32 to 1e-5 of it (sums in
    another order); the input grid untouched, the mass added the values'
    sum; positions and values given as column slices of one tensor the
    same; no sources give the grid back."""
    from baryonforge_torch.ops import scatter
    rng = np.random.default_rng(ndim * 1000 + N)
    grid = torch.as_tensor(rng.uniform(0, 1, (N,) * ndim), dtype=dt,
                           device=dev)
    pos = rng.uniform(-N / 4, 5 * N / 4, (M, ndim))
    pos[: M // 10] = np.floor(pos[: M // 10])
    pos[-4:] = np.array([-N, N, -1e-9, 0.0])[:, None]
    pos = torch.as_tensor(pos, dtype=dt, device=dev)
    vals = torch.as_tensor(rng.uniform(0, 2, M), dtype=dt, device=dev)
    keep = grid.clone()
    fn = scatter.deposit_2d if ndim == 2 else scatter.deposit_3d
    plain = scatter.deposit_2d_plain if ndim == 2 else \
        scatter.deposit_3d_plain
    _build.reset_launches()
    ok = fn(grid, pos, vals)
    assert _build.launches["deposit_list"] == 1
    op = plain(grid, pos, vals)
    assert ok.dtype == dt and ok.shape == grid.shape
    assert torch.equal(grid, keep)
    rel = 1e-12 if dt == torch.float64 else 1e-5
    torch.testing.assert_close(ok, op, rtol=0,
                               atol=rel * op.abs().max().item())
    added = (ok.double().sum() - grid.double().sum()).item()
    assert abs(added / vals.double().sum().item() - 1) < 10 * rel
    # column slices of one (M, d + 1) tensor: two contiguous copies made
    # by the wrapper, both alive at the launch
    data = torch.cat([pos, vals[:, None]], 1)
    cols = fn(grid, data[:, :ndim], data[:, ndim])
    assert _build.launches["deposit_list"] == 2
    torch.testing.assert_close(cols, op, rtol=0,
                               atol=rel * op.abs().max().item())
    empty = fn(grid, pos[:0], vals[:0])
    assert torch.equal(empty, grid) and _build.launches["deposit_list"] == 2


def _grid_case(ndim, ell, dev, npix=64, n=40):
    rng = np.random.default_rng(21)
    L = float(npix)
    cen = rng.integers(0, npix, (n, ndim)).astype(np.int32)
    halos = {"cen": torch.as_tensor(cen, device=dev),
             "doff": torch.as_tensor(rng.uniform(-0.5, 0.5, (n, ndim)),
                                     device=dev),
             "rmax": torch.as_tensor(rng.uniform(3, 9, n), device=dev),
             "rscale": torch.as_tensor(rng.uniform(0.5, 1.5, n), device=dev),
             "rmat": None}
    if ell:
        from baryonforge_torch.Runners.Map2DRunner import _shear_matrix
        halos["rmat"] = torch.as_tensor(
            _shear_matrix(rng.normal(size=(n, 2)), rng.uniform(0.5, 0.9, n)),
            device=dev)
    return L / npix, halos


@pytest.mark.parametrize("mode,ndim,ell",
                         [("displace", 2, False), ("displace", 2, True),
                          ("displace", 3, False), ("paint", 2, False),
                          ("paint", 2, True), ("paint", 3, False),
                          ("anis", 2, False)])
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("grid", ["whole", "partial", "odd"])
def test_grid_cutout_kernel(dev, mode, ndim, ell, dt, grid):
    """K15 against its plain version, two cutout sizes into one
    accumulator, with the paint's tSZ curves (log and raw) and the
    Schneider19 table's displacement curves: float64 to 1e-10 of the
    largest value, float32 offsets to 1e-5 of it (float32 sums in another
    order); two calls bitwise equal (each tile adds its halos in ascending
    order, no atomics). "whole": grids of whole tiles (2D N 64, 3D N 24),
    cutouts of 8 and 14 cells; "partial": grids whose last tiles are
    partial (2D N 100 with 16^2 tiles, 3D N 20 with 8^3), two halos on the
    periodic edges, cutouts of 20 cells and of the whole grid; "odd": grids
    of N 26 (partial tiles; the runners clip cutouts to N // 2 = 13), odd
    cutouts of 13 and 5 cells, halo 0's box of 13 ending on a tile's first
    cell."""
    if grid == "whole":
        npix = 64 if ndim == 2 else 24
        res, halos = _grid_case(ndim, ell, dev, npix)
        n = halos["cen"].shape[0]
        buckets = ((slice(0, n // 2), 8), (slice(n // 2, n), 14))
    elif grid == "partial":
        npix = 100 if ndim == 2 else 20
        res, halos = _grid_case(ndim, ell, dev, npix, n=24)
        halos["cen"][0] = 0
        halos["cen"][1] = npix - 1
        n = halos["cen"].shape[0]
        buckets = ((slice(0, n - 2), 20), (slice(n - 2, n), npix))
    else:
        npix = 26
        res, halos = _grid_case(ndim, ell, dev, npix, n=24)
        halos["cen"][0] = bf.ops.grid.TILE[ndim] - 6
        halos["rmax"][0] = 9.0
        n = halos["cen"].shape[0]
        buckets = ((slice(0, n // 2), 13), (slice(n // 2, n), 5))
    M = np.geomspace(6e12, 1.5e15, n)
    a = np.full(n, 1 / 1.9)
    if mode == "displace":
        m = _model().with_dtype(torch.float64, device=dev)
        c, r0, dl = interp.collapse_curves_plain(m._table, m._axes, 2, M, a,
                                                 [], {})
        curve, curve2 = (c.to(dt), float(r0), float(dl), False), None
        acc = torch.zeros((ndim, npix ** ndim), dtype=dt, device=dev)
    else:
        (c1, r1, d1, l1), (c2, r2, d2, l2) = _anis_curves(
            {"M": M, "a": a}, ("log", "raw"), dev)
        curve, curve2 = (c1.to(dt), r1, d1, l1), (c2.to(dt), r2, d2, l2)
        acc = torch.zeros(npix ** ndim, dtype=torch.float64, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    mtot = torch.rand(npix ** ndim, dtype=torch.float64, device=dev,
                      generator=g)
    orig = torch.rand(npix ** ndim, dtype=torch.float64, device=dev,
                      generator=g)
    kw = dict(a=1 / 1.9, mtot=mtot, orig=orig)
    ak, ak2, ap = acc.clone(), acc.clone(), acc.clone()
    _build.reset_launches()
    for sl, Ns in buckets:
        sub = {k: None if v is None else v[sl] for k, v in halos.items()}
        args = (mode, npix, Ns, res, sub, (curve[0][sl],) + curve[1:])
        c2 = None if mode != "anis" else (curve2[0][sl],) + curve2[1:]
        bf.ops.grid.grid_cutout(*args, ak, c2, **kw)
        bf.ops.grid.grid_cutout(*args, ak2, c2, **kw)
        bf.ops.grid.grid_cutout_plain(*args, ap, c2, **kw)
    assert _build.launches["grid_cutout"] == 4
    assert torch.equal(ak, ak2)
    scale = ap.abs().max().item()
    assert scale > 0
    rel = 1e-10 if dt == torch.float64 or mode != "displace" else 1e-5
    torch.testing.assert_close(ak, ap, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("ndim,npix,ell", [(2, 100, False), (2, 64, True),
                                           (2, 26, True), (3, 20, False),
                                           (3, 24, False), (3, 26, False)])
@pytest.mark.parametrize("Ns", [5, 6, 13, 14, "N"])
def test_tile_pairs_kernel(dev, ndim, npix, ell, Ns):
    """K15's (tile, halo) lists on the card (its pair kernel, then the
    sort) equal to those of the pair kernel's plain version on the CPU;
    odd Ns, and halo 2's box ending on a tile's first cell."""
    Ns = npix if Ns == "N" else Ns
    res, halos = _grid_case(ndim, ell, dev, npix)
    halos["cen"][0] = 0
    halos["cen"][1] = npix - 1
    halos["cen"][2] = (bf.ops.grid.TILE[ndim] - (Ns - 1 - Ns // 2)) % npix
    _build.reset_launches()
    card = bf.ops.grid.cutout_tiles(npix, Ns, res, halos)
    assert _build.launches["tile_pairs"] == 1
    cpu = bf.ops.grid.cutout_tiles(npix, Ns, res, {
        k: None if v is None else v.cpu() for k, v in halos.items()})
    n = int(cpu[0][-1])
    assert n > 0
    assert torch.equal(card[0].cpu(), cpu[0])
    assert torch.equal(card[1][:n].cpu(), cpu[1][:n])


def test_grid_runners_cuda_match_cpu(dev):
    """BaryonifyGrid (3D and 2D with ellipticity), PaintProfilesGrid (3D)
    and PaintProfilesAnisGrid (2D) on the card against the plain versions
    on the CPU, float64, to 1e-9 of the largest value (of the moved mass
    for BaryonifyGrid)."""
    rng = np.random.default_rng(4)
    tab = _dm_table(dev)
    for ndim, npix in ((3, 32), (2, 96)):
        L = float(npix)
        n = 30
        cols = dict(x=rng.uniform(0, L, n), y=rng.uniform(0, L, n),
                    M=10 ** rng.uniform(13.5, 14.8, n))
        if ndim == 3:
            cols["z"] = rng.uniform(0, L, n)
        else:
            cols.update(q_ell=rng.uniform(0.5, 0.9, n),
                        A_ell=rng.normal(size=(n, 2)))
        cat = bf.utils.HaloNDCatalog(**cols, redshift=0.9, cosmo=COSMO)
        gm = bf.utils.GriddedMap(map=rng.exponential(1.0, (npix,) * ndim),
                                 bins=(np.arange(npix) + 0.5) * (L / npix),
                                 cosmo=COSMO, redshift=0.9)
        runs = [(bf.BaryonifyGrid, dict(epsilon_max=20, model=_model(),
                                        use_ellipticity=ndim == 2))]
        if ndim == 3:
            runs.append((bf.PaintProfilesGrid, dict(epsilon_max=5,
                                                    model=tab)))
        else:
            runs.append((bf.PaintProfilesAnisGrid, dict(
                epsilon_max=5, model=tab, Tracer_model=tab, Mtot_model=tab,
                background_val=1.0, global_tracer_fraction=0.1)))
        for cls, kw in runs:
            kw.update(dtype=torch.float64)
            _build.reset_launches()
            out_g = cls(cat, gm, device=dev, **kw).process()
            assert _build.launches["grid_cutout"] >= 1, _build.launches
            out_c = cls(cat, gm, device="cpu", **kw).process()
            ref = (np.abs(out_c - gm.map).max() if cls is bf.BaryonifyGrid
                   else np.abs(out_c).max())
            assert ref > 0
            np.testing.assert_allclose(out_g, out_c, rtol=0, atol=1e-9 * ref)


# ---- the remaining profile families: Arico20, Mead20, Schneider25, B12 ----
# the Arico20 fiducial set (examples/05_profile_gallery.py:34-41) and
# tests/defaults.py:21-29's Schneider25 parameters
A20 = dict(cdelta=4, alpha_g=2, epsilon_h=0.015, M1_0=2.2e11 / 0.7,
           alpha_fsat=1, M1_fsat=1, delta_fsat=1, gamma_fsat=1,
           eps_fsat=1, M_c=1.2e14 / 0.7, eta=0.6, mu=0.31, beta=0.6,
           epsilon_hydro=np.sqrt(5), M_inn=3.3e13 / 0.7, M_r=1e16,
           beta_r=2, theta_inn=0.1, theta_out=3, theta_rg=0.3,
           sigma_rg=0.1, a=0.3, n=2, p=0.3, q=0.707,
           A_nt=0.495, alpha_nt=0.1, mean_molecular_weight=0.59)
S25 = dict(epsilon0=4, epsilon1=0.5, alpha_excl=0.4, p=0.3, q=0.707,
           M_c=1e15, mu=0.8, q0=0.075, q1=0.25, q2=0.7, nu_q0=0, nu_q1=1,
           nu_q2=0, nstep=3 / 2, theta_c=0.3, nu_theta_c=1 / 2, c_iga=0.1,
           nu_c_iga=3 / 2, r_min_iga=1e-3, alpha=1, gamma=3 / 2, delta=7,
           tau=-1.376, tau_delta=0, Mstar=3e11, Nstar=0.03, eta=0.1,
           eta_delta=0.22, epsilon_cga=0.03, alpha_nt=0.1, nu_nt=0.5,
           gamma_nt=0.8, mean_molecular_weight=0.6125)
FAMILY_GRID = dict(z_min=0.1, z_max=1.1, N_samples_z=2, M_min=5e12,
                   M_max=3e15, N_samples_Mass=4, R_min=1e-3, R_max=50,
                   N_samples_R=16, verbose=False)


def _family_table(family, dev):
    """The family's small table, built on ``dev``: Arico20
    Baryonification3D, Mead20 (T_AGN 10^7.8, with the two-halo terms) and
    Schneider25 Baryonification2D, and a TabulatedProfile of the
    Battaglia12 200_AGN electron pressure."""
    P = bf.Profiles
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    if family == "Battaglia12":
        return bf.utils.TabulatedProfile(
            P.Battaglia.ElectronPressure("200_AGN", proj_cutoff=100), cosmo,
            device=dev).setup_interpolator(**FAMILY_GRID)
    if family == "Arico20":
        cls, o, b = (bf.Baryonification3D, P.Arico20.DarkMatterOnly(**A20),
                     P.Arico20.DarkMatterBaryon(**A20))
    elif family == "Mead20":
        m20 = dict(P.Mead20.Tagn2pars(7.8), proj_cutoff=100)
        cls, o, b = (bf.Baryonification2D,
                     P.Mead20.DarkMatterOnlywithLSS(**m20),
                     P.Mead20.DarkMatterBaryonwithLSS(**m20))
    else:
        s25 = dict(S25, proj_cutoff=100)
        cls, o, b = (bf.Baryonification2D,
                     P.Schneider25.DarkMatterOnly(**s25),
                     P.Schneider25.DarkMatterBaryon(**s25))
    return cls(o, b, cosmo, epsilon_max=20, device=dev).setup_interpolator(
        **FAMILY_GRID)


@pytest.mark.parametrize("family", ["Arico20", "Mead20", "Schneider25",
                                    "Battaglia12"])
def test_family_table_cuda_matches_cpu(dev, family):
    """Each family's small table built on the card (profiles in torch, K8
    for the two-halo terms, K9 for the rows) against the CPU build, to
    1e-9 of the largest |d| (of the logs for the tabulated profile)."""
    _build.reset_launches()
    g = _family_table(family, dev)
    if family != "Battaglia12":
        assert _build.launches["table_rows"] == 2, _build.launches
    if family in ("Mead20", "Schneider25"):
        assert _build.launches["fht"] >= 2, _build.launches
    c = _family_table(family, "cpu")
    if family == "Battaglia12":
        for k in ("raw_input_2D", "raw_input_3D"):
            np.testing.assert_allclose(getattr(g, k), getattr(c, k),
                                       rtol=0, atol=1e-9)
        return
    scale = np.abs(c.raw_input_d).max()
    assert scale > 0
    np.testing.assert_allclose(g.raw_input_d, c.raw_input_d, rtol=0,
                               atol=1e-9 * scale)


def test_safe_pchip_minimize_cuda_matches_cpu(dev):
    """The row-batched root finder on the card against the CPU on seeded
    cubics (crossings anywhere, the window clipped at both ends), falling
    rows and the no-crossing fallbacks (+inf; x at the smallest |y|), to
    1e-12."""
    from baryonforge_torch.utils.misc import safe_Pchip_minimize
    rng = np.random.default_rng(11)
    x = np.linspace(-1.0, 3.0, 300)
    roots = np.concatenate([rng.uniform(-1.0, 3.0, 40), [-0.99, 2.99]])
    ys = [s * ((x - x0) ** 3 + rng.uniform(0.01, 1) * (x - x0))
          for x0, s in zip(roots, rng.choice([-1.0, 1.0], roots.size))]
    ys = np.array(ys + [(x - 1.0) ** 2 + 0.3, -np.exp(x),
                        np.zeros_like(x)])
    for xs in (x, np.tile(x, (len(ys), 1))):
        c = safe_Pchip_minimize(torch.as_tensor(ys), torch.as_tensor(xs))
        g = safe_Pchip_minimize(torch.as_tensor(ys, device=dev),
                                torch.as_tensor(xs, device=dev))
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-12,
                                   atol=1e-12)
        assert np.isinf(c[-3]) and c[-2] == x[0] and c[-1] == x[0]


def test_a20_grid_cuda_matches_cpu(dev):
    """BaryonifyGrid 3D (32^3 cells of a 32 Mpc box, 30 halos at z 0.2)
    from the Arico20 small table (built on the CPU) on the card against
    the plain versions on the CPU, float64, to 1e-9 of the largest move;
    mass to 1e-10."""
    tab = _family_table("Arico20", "cpu")
    rng = np.random.default_rng(6)
    n, L = 30, 32.0
    cat = bf.utils.HaloNDCatalog(
        x=rng.uniform(0, L, n), y=rng.uniform(0, L, n),
        z=rng.uniform(0, L, n), M=10 ** rng.uniform(13.5, 14.8, n),
        redshift=0.2, cosmo=COSMO)
    gm = bf.utils.GriddedMap(map=rng.exponential(1.0, (32,) * 3),
                             bins=(np.arange(32) + 0.5), cosmo=COSMO,
                             redshift=0.2)
    kw = dict(epsilon_max=20, model=tab, dtype=torch.float64)
    _build.reset_launches()
    out_g = bf.BaryonifyGrid(cat, gm, device=dev, **kw).process()
    assert _build.launches["grid_deposit"] >= 1, _build.launches
    out_c = bf.BaryonifyGrid(cat, gm, device="cpu", **kw).process()
    ref = np.abs(out_c - gm.map).max()
    assert ref > 0
    np.testing.assert_allclose(out_g, out_c, rtol=0, atol=1e-9 * ref)
    np.testing.assert_allclose(out_g.sum(), gm.map.sum(), rtol=1e-10)


def _snapshot_case(ndim, dt, dev, L=64.0, n=4000, nh=30, seed=5, n_r=None):
    """Particles, halos and their pairs in a small box whose largest query
    radius exceeds L / 3, with the S19 table's curves at z 0.9 (resampled
    onto ``n_r`` radii over the same range when given)."""
    from scipy.spatial import cKDTree
    from baryonforge_torch import native
    rng = np.random.default_rng(seed + ndim)
    pos = rng.uniform(-0.5, L + 0.5, (n, ndim))
    hpos = rng.uniform(0, L, (nh, ndim))
    R_q = rng.uniform(2, 0.45 * L, nh)
    if ndim == 3:
        counts, idx = native.cell_query(pos, L, hpos, R_q)
    else:
        lists = cKDTree(np.mod(pos, L), boxsize=L).query_ball_point(
            np.mod(hpos, L), R_q)
        counts = np.array([len(x) for x in lists])
        idx = np.concatenate([np.asarray(x, np.int32) for x in lists])
    csr = tt.pairs_csr(np.repeat(np.arange(nh, dtype=np.int32), counts), idx)
    m = _model().with_dtype(torch.float64, device=dev)
    c, r0, dl = interp.collapse_curves_plain(
        m._table, m._axes, 2, np.geomspace(1e13, 1e15, nh),
        np.full(nh, 1 / 1.9), [], {})
    if n_r is not None:
        lr = float(r0) + float(dl) * np.arange(c.shape[1])
        fine = np.linspace(lr[0], lr[-1], n_r)
        c = torch.as_tensor(np.stack([np.interp(fine, lr, row)
                                      for row in c.cpu().numpy()]),
                            device=dev)
        dl = (lr[-1] - lr[0]) / (n_r - 1)
    T = lambda x, d=torch.float64: torch.as_tensor(x, device=dev).to(d)
    return (T(pos), T(hpos), *[torch.as_tensor(x, device=dev) for x in csr],
            c.to(dt), float(r0), float(dl), T(rng.uniform(0.5, 2, nh), dt),
            T(R_q * 0.95, dt), L)


@pytest.mark.parametrize("n_r", [None, 8192])
@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_snapshot_displace_kernel(dev, dt, ndim, n_r):
    """K17 against its plain versions on the card (the halo-major
    reference and the gather): float64 to 1e-10 of the largest offset,
    float32 to tests/test_snapshot.py:67 (atol 5e-4, rtol 1e-3); two
    launches bitwise equal (no atomics); curves of the table's radii and
    of 8192 (a curve is read from device memory, not staged). The records'
    size is the kernel's."""
    from baryonforge_torch.ops import snapshot
    args = _snapshot_case(ndim, dt, dev, n_r=n_r)
    rec = snapshot._records(args[1], args[2], args[8], args[9])
    assert rec.shape[1] * 8 == _build.library().bf_snapshot_record_bytes(
        int(dt == torch.float64))
    layout = snapshot.particle_layout(args[0], args[-1], args[3], args[4])
    _build.reset_launches()
    got = snapshot.snapshot_displace(*args, layout)
    again = snapshot.snapshot_displace(*args, layout)
    assert _build.launches["snapshot_displace"] == 2
    assert torch.equal(got, again)
    want = snapshot.snapshot_displace_plain(*args)
    gather = snapshot.snapshot_gather_plain(*args, layout)
    scale = want.abs().max().item()
    assert scale > 0 and got.dtype == dt
    for ref in (want, gather):
        if dt == torch.float64:
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-10 * scale)
        else:
            torch.testing.assert_close(got, ref, rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("ndim", [3, 2])
def test_snapshot_cuda_matches_cpu(dev, ndim):
    """BaryonifySnapshot on the card against the plain versions on the CPU,
    float64, to 1e-10 of the largest displacement."""
    rng = np.random.default_rng(ndim)
    L, n, nh = 96.0, 5000, 25
    cols = {c: rng.uniform(0, L, n) for c in "xyz"[:ndim]}
    hcols = {c: rng.uniform(0, L, nh) for c in "xyz"[:ndim]}
    snap = bf.utils.ParticleSnapshot(**cols, M=np.ones(n), L=L, cosmo=COSMO,
                                     redshift=0.9)
    cat = bf.utils.HaloNDCatalog(**hcols, M=10 ** rng.uniform(13, 15, nh),
                                 redshift=0.9, cosmo=COSMO)
    kw = dict(epsilon_max=20, model=_model(), dtype=torch.float64)
    _build.reset_launches()
    out_g = bf.BaryonifySnapshot(cat, snap, device=dev, **kw).process()
    assert _build.launches["snapshot_displace"] == 1, _build.launches
    assert _build.launches["collapse_curves"] == 1, _build.launches
    out_c = bf.BaryonifySnapshot(cat, snap, device="cpu", **kw).process()
    move = max(np.abs(out_c[c] - snap.cat[c]).max() for c in cols)
    assert move > 0
    for c in cols:
        np.testing.assert_allclose(out_g[c], out_c[c], rtol=0,
                                   atol=1e-10 * move)


@pytest.mark.parametrize("nside,lmax,smem_bytes", [(8, 23, None),
                                                   (64, 191, None),
                                                   (64, 100, 2048),
                                                   (48, 143, None)],
                         ids=["8", "64", "64-long", "48"])
def test_ring_modes_kernel(dev, nside, lmax, smem_bytes):
    """K18 against its plain version on the card, within
    ops.sht.ring_modes_tolerance (the plain version's angle rounding):
    NSIDE 8 with lmax 23 (m wraps past nr), 64, 48 (cap lengths with large
    prime factors and a belt of 192: Bluestein), and 64 with 2048 bytes of
    shared memory a ring, which sends the longer rings to slots of device
    memory."""
    from baryonforge_torch.ops import sht
    g = torch.Generator(device=dev).manual_seed(nside)
    hmap = torch.randn(12 * nside * nside, dtype=torch.float64, device=dev,
                       generator=g)
    kw = {} if smem_bytes is None else dict(smem_bytes=smem_bytes)
    groups = sht.ring_plan(nside, smem_bytes
                           or sht.shared_memory_optin(hmap.device))[1]
    if smem_bytes is not None:
        assert not groups[:, 4].all()       # some rings in device memory
    _build.reset_launches()
    fr, fi = sht._ring_modes_kernel(hmap, nside, lmax, **kw)
    assert _build.launches["ring_modes"] == 1
    pr, pi = sht.ring_modes_plain(hmap, nside, lmax)
    tol = sht.ring_modes_tolerance(hmap, nside, lmax)
    assert float(((fr - pr).abs() / tol).max()) <= 1.0
    assert float(((fi - pi).abs() / tol).max()) <= 1.0


@pytest.mark.parametrize("nside,lmax,heights",
                         [(16, 47, "mirrored"), (48, 143, "mirrored"),
                          (48, 143, "jax"), (64, 191, "mirrored"),
                          (64, 191, "jax"), (2048, 16, "mirrored"),
                          (2048, 16, "jax")])
def test_legendre_alm_kernel(dev, nside, lmax, heights):
    """K19 against its plain version on the card, to 4 n_ring eps of the
    absolute contraction sum_r |F| |lambda| (the sums over rings in another
    order), on the mirrored heights (ops.sht.ring_heights: every ring in a
    pair) and on the JAX heights (the south belt unpaired); NSIDE 2048 has
    more chains than a block takes (atomic sums over chunks of chains),
    and no pair is split across chunks."""
    from baryonforge_torch.ops import sht
    zn = (sht.ring_heights(nside) if heights == "mirrored"
          else sht.ring_geometry(nside)[2])
    z = torch.as_tensor(zn, device=dev)
    chains = sht.mirror_pairs(zn)
    rings = chains[chains >= 0]
    assert np.array_equal(np.sort(rings), np.arange(z.numel()))
    per = _build.library().bf_legendre_chains_per_block()
    chunk = np.arange(len(chains)) // per
    paired = chains[:, 1] >= 0
    where = np.empty(z.numel(), dtype=np.int64)
    where[chains[:, 0]] = chunk
    where[chains[paired, 1]] = chunk[paired]
    assert np.array_equal(where[chains[paired, 0]], where[chains[paired, 1]])
    assert (nside == 2048) == (chunk[-1] > 0)
    if heights == "mirrored":
        assert len(chains) == 2 * nside
    g = torch.Generator(device=dev).manual_seed(nside)
    fr, fi = (torch.randn((z.numel(), lmax + 1), dtype=torch.float64,
                          device=dev, generator=g) for _ in range(2))
    _build.reset_launches()
    ar, ai = sht.legendre_alm(z, fr, fi, lmax)
    assert _build.launches["legendre_alm"] == 1
    pr, pi = sht.legendre_alm_plain(z, fr, fi, lmax)
    sr, si = sht.legendre_alm_plain(z, fr, fi, lmax, absolute=True)
    eps = float(np.finfo(np.float64).eps)
    for k, p, s in ((ar, pr, sr), (ai, pi, si)):
        assert float(((k - p).abs() - 4 * z.numel() * eps * s).max()) <= 0
        assert bool((k.tril(-1) == 0).all())


def test_anafast_cuda_matches_cpu(dev):
    """utils.sht.anafast on the card (K18, K19) against the plain versions
    on the CPU, NSIDE 32, to 1e-10 of the largest C_l."""
    from baryonforge_torch.utils import sht
    hmap = np.random.default_rng(3).standard_normal(12 * 32 * 32)
    _build.reset_launches()
    cl_g = sht.anafast(hmap)
    assert _build.launches["ring_modes"] == 1
    assert _build.launches["legendre_alm"] == 1
    cl_c = sht.anafast(hmap, device="cpu")
    np.testing.assert_allclose(cl_g, cl_c, rtol=0,
                               atol=1e-10 * np.abs(cl_c).max())
