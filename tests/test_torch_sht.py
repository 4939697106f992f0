"""The spherical-harmonic analysis of the torch port (the plain versions of
kernels K18 and K19 on the CPU; utils.sht.ring_alm_real and anafast with
device="cpu") against baryonforge_tpu.utils.sht, the brute-force sum and
the analytic maps of tests/test_sht.py, and the ΔCl recipe of
tests/test_deltacl.py (paint, baryonify, anafast) against the JAX one.

Tolerances: a_lm and C_l to 1e-10 of the largest value (the packages sum
in other orders); the brute force, monopole and single-mode checks as
tests/test_sht.py:38-58; the ΔCl ratios to 1e-8 (both recipes in float64;
the maps agree to ~1e-13 of their largest value).
"""

import numpy as np
import pytest
from scipy.special import sph_harm_y

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Profiles as JProfiles           # noqa: E402
from baryonforge_tpu import Runners as JRunners             # noqa: E402
from baryonforge_tpu import utils as JUtils                 # noqa: E402
from baryonforge_tpu.Profiles.BaryonCorrection import \
    Baryonification2D as JB2D                               # noqa: E402
from baryonforge_tpu.ops import healpix as jhpx            # noqa: E402
from baryonforge_tpu.utils import sht as jsht               # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import sht as osht               # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402
from baryonforge_torch.utils import sht as tsht             # noqa: E402

from defaults import COSMO, COSMO_DICT, bpar_S19            # noqa: E402
from test_runners_extra import _tab                         # noqa: E402


def _map(nside, seed):
    return np.random.default_rng(seed).standard_normal(12 * nside * nside)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("nside", [8, 16, 32])
def test_ring_geometry_matches_jax(nside):
    for t, j in zip(tsht._ring_geometry(nside), jsht._ring_geometry(nside)):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("nside,lmax", [(8, 23), (16, 20), (32, 95)])
def test_ring_modes_plain_matches_jax(nside, lmax):
    hmap = _map(nside, nside)
    jr, ji = jsht._ring_modes(nside, jnp.asarray(hmap), lmax)
    tr, ti = osht.ring_modes(torch.as_tensor(hmap), nside, lmax)
    assert _rel(tr, jr) < 1e-10 and _rel(ti, ji) < 1e-10


# the H100's dynamic shared memory a block may opt in to (bytes)
H100_SMEM = 232448


@pytest.mark.parametrize("nside,smem", [(8, H100_SMEM), (48, H100_SMEM),
                                        (1024, H100_SMEM), (2048, H100_SMEM),
                                        (64, 2048)])
def test_ring_plan_covers_every_ring(nside, smem):
    """K18's launch plan: every ring in one group, the ring ids ascending
    in each; a power-of-two n = nr / 2 runs its own FFT size, any other n
    Bluestein's least power of two M >= 2 n - 1; shared-memory groups fit
    ``smem`` bytes (4 M doubles, 6 M for Bluestein) and the others do
    not."""
    _, nr, _, _ = osht.ring_geometry(nside)
    rings, groups = osht.ring_plan(nside, smem)
    assert sorted(rings.tolist()) == list(range(nr.size))
    assert groups[:, 1].sum() == nr.size
    for first, count, M, blue, shared in groups.tolist():
        ids = rings[first:first + count]
        assert (np.diff(ids) > 0).all()
        n = nr[ids] // 2
        if blue:
            assert ((n & (n - 1)) != 0).all()
            assert ((2 * n - 1 <= M) & (M < 4 * n - 2)).all()
        else:
            assert (n == M).all() and M & (M - 1) == 0
        need = 8 * (6 if blue else 4) * M
        assert (need <= smem) == bool(shared)
    if nside == 1024:
        # the belt (n 2048) and the longest caps (M 4096) in shared memory
        assert groups[:, 4].all()


@pytest.mark.parametrize("nside,lmax", [(8, 23), (16, 47), (32, 60)])
def test_legendre_plain_matches_jax(nside, lmax):
    hmap = _map(nside, nside + 1)
    _, _, z, _ = jsht._ring_geometry(nside)
    jr, ji = jsht._ring_modes(nside, jnp.asarray(hmap), lmax)
    ar, ai = jsht._alm_from_modes(jnp.asarray(z), jr, ji, lmax)
    jr, ji = (torch.tensor(np.asarray(x)) for x in (jr, ji))
    tr, ti = osht.legendre_alm(torch.as_tensor(z), jr, ji, lmax)
    assert _rel(tr, ar) < 1e-10 and _rel(ti, ai) < 1e-10
    # the absolute contraction bounds the signed one
    sr, si = osht.legendre_alm_plain(torch.as_tensor(z), jr, ji, lmax,
                                     absolute=True)
    assert bool((tr.abs() <= sr * (1 + 1e-12)).all())
    assert bool((ti.abs() <= si * (1 + 1e-12)).all())


@pytest.mark.parametrize("nside", [8, 16, 32])
def test_ring_alm_real_matches_jax(nside):
    lmax = 3 * nside - 1
    hmap = _map(nside, 2 * nside)
    jr, ji = jsht.ring_alm_real(nside, hmap, lmax)
    tr, ti = tsht.ring_alm_real(nside, hmap, lmax, device="cpu")
    assert tr.shape == (lmax + 1, lmax + 1) and tr.dtype == torch.float64
    assert _rel(tr, jr) < 1e-10 and _rel(ti, ji) < 1e-10
    # zero below the diagonal, exactly
    low = torch.tril(torch.ones(lmax + 1, lmax + 1, dtype=torch.bool), -1)
    assert bool((tr[low] == 0).all()) and bool((ti[low] == 0).all())


@pytest.mark.parametrize("nside,lmax", [(8, 12), (16, None), (32, None)])
def test_anafast_matches_jax(nside, lmax):
    hmap = _map(nside, 3 * nside)
    want = jsht.anafast(hmap, lmax=lmax)
    got = tsht.anafast(torch.as_tensor(hmap), lmax=lmax, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def _brute_cl(nside, hmap, lmax):
    """tests/test_sht.py:15-28."""
    npix = hmap.size
    theta, phi = (np.asarray(x) for x in
                  jhpx.pix2ang(nside, np.arange(npix)))
    omega = 4 * np.pi / npix
    cl = np.zeros(lmax + 1)
    for l in range(lmax + 1):
        tot = 0.0
        for m in range(-l, l + 1):
            ylm = sph_harm_y(l, m, theta, phi)
            tot += np.abs(omega * np.sum(hmap * np.conj(ylm))) ** 2
        cl[l] = tot / (2 * l + 1)
    return cl


def test_anafast_matches_brute_force():
    nside, lmax = 8, 12
    hmap = np.random.default_rng(9).standard_normal(12 * nside * nside)
    ours = tsht.anafast(hmap, lmax=lmax, device="cpu")
    np.testing.assert_allclose(ours, _brute_cl(nside, hmap, lmax),
                               rtol=1e-8, atol=1e-12)


def test_single_mode_map():
    """A map = Re Y_40 has power only at l = 4 (up to pixelization)."""
    nside, lmax = 16, 10
    theta, phi = (np.asarray(x) for x in
                  jhpx.pix2ang(nside, np.arange(12 * nside * nside)))
    cl = tsht.anafast(np.real(sph_harm_y(4, 0, theta, phi)), lmax=lmax,
                      device="cpu")
    assert cl[4] == pytest.approx(1.0 / 9.0, rel=0.1)
    assert np.delete(cl, 4).max() < 5e-3 * cl[4]


def test_constant_map_is_monopole():
    nside = 8
    cl = tsht.anafast(np.full(12 * nside * nside, 2.5), lmax=6,
                      device="cpu")
    assert cl[0] == pytest.approx(4 * np.pi * 2.5 ** 2, rel=1e-10)
    assert np.abs(cl[1:]).max() < 1e-5 * cl[0]


def test_refusals():
    with pytest.raises(ValueError, match="healpix"):
        tsht.anafast(np.zeros(100), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsht.anafast(np.zeros(12 * 4 * 4))


def _recipe(U, R, sht_anafast, cat, tab, model, nside, **kw):
    """tests/test_deltacl.py:24-66 with one package: the DMO paint plus
    its mean, its baryonification, and the C_l of both contrasts; returns
    (the two maps, the ratio C_l(baryonified) / C_l(DMO))."""
    npix = 12 * nside * nside
    zero = U.LightconeShell(map=np.zeros(npix), cosmo=COSMO_DICT)
    mass = R.PaintProfilesShell(cat, zero, epsilon_max=10, model=tab,
                                include_pixel_size=True, **kw).process()
    mass = mass + mass.mean()
    new = R.BaryonifyShell(cat, U.LightconeShell(map=mass, cosmo=COSMO_DICT),
                           epsilon_max=20, model=model, **kw).process()
    lmax = 3 * nside - 1
    cl0 = sht_anafast(mass / mass.mean() - 1.0, lmax)
    cl1 = sht_anafast(new / new.mean() - 1.0, lmax)
    return mass, new, cl1 / cl0


def test_deltacl_recipe_matches_jax():
    """The ΔCl recipe at NSIDE 32 (40 halos, z 0.08 to 0.15), both packages
    in float64 with the scatter engines, the JAX tables carried across; the
    JAX runners with one size bucket (their compiled scatter body is keyed
    on the batch shapes, not on the disc window: ROADMAP Queue 3)."""
    nside, n = 32, 40
    rng = np.random.default_rng(13)
    cols = dict(ra=rng.uniform(0, 360, n),
                dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
                M=10 ** rng.uniform(14.0, 15.0, n),
                z=rng.uniform(0.08, 0.15, n))
    jtab = _tab()
    jmodel = JB2D(JProfiles.DarkMatterOnly(**bpar_S19, proj_cutoff=100),
                  JProfiles.DarkMatterBaryon(**bpar_S19, proj_cutoff=100),
                  COSMO, epsilon_max=20)
    jmodel.setup_interpolator(z_min=0.05, z_max=0.3, N_samples_z=2,
                              M_min=5e13, M_max=3e15, N_samples_Mass=4,
                              R_min=1e-3, R_max=60, N_samples_R=32,
                              verbose=False)
    jm, jn, jratio = _recipe(
        JUtils, JRunners, lambda m, lmax: jsht.anafast(m, lmax=lmax),
        JUtils.HaloLightConeCatalog(**cols, cosmo=COSMO_DICT), jtab, jmodel,
        nside, deposit="scatter", dtype=jnp.float64, n_size_buckets=1,
        verbose=False)
    tm, tn, tratio = _recipe(
        bf.utils, bf, lambda m, lmax: tsht.anafast(m, lmax=lmax,
                                                   device="cpu"),
        bf.utils.HaloLightConeCatalog(**cols, cosmo=COSMO_DICT),
        convert.tabulated_from_jax(jtab, device="cpu"),
        convert.baryonification_from_jax(jmodel, device="cpu"), nside,
        deposit="scatter", dtype=torch.float64, device="cpu")
    assert _rel(tm, jm) < 1e-10 and _rel(tn, jn) < 1e-10
    assert np.abs(tn - tm).max() > 1e-3 * np.abs(tm).max()
    np.testing.assert_allclose(tratio[2:], jratio[2:], rtol=1e-8)
