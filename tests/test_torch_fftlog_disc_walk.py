"""The routes of kernels K8 (FFTLog) and K13 (the anisotropic disc paint),
checked on the CPU against the JAX package.

K8 runs a row as one FFT in shared memory (a power of two up to 4096
points on the H100), as Bluestein's chirp convolution in shared memory
(any other N up to 2048), or as either in passes over device memory
(longer rows, any M, as many rows at once as the free memory holds:
``ops.fftlog.fht_slots``); ``ops.fftlog.fht_plan`` picks the route. Its plain version,
``fht_plain``, is held against the JAX ``fht`` at the lengths where the
route changes: N = 2048 (a power of two in shared memory) and N = 3000
(Bluestein on device memory), to tests/test_torch_fftlog.py's tolerance
(1e-12 of the largest value). A power of two past 4096 is left out: the
JAX ``fht`` forms two N x N DFT matrices, 1 GB at N = 8192.

K13 walks K2's flat layout of each disc (``deposit.disc_walk_plain``), so
its member set must be the JAX scatter body's, the mask of
``ops.healpix.disc_pixels``: on the catalog of tests/test_torch_anis.py
(24 halos, z 0.1 to 0.4, epsilon_max 20) with discs added at both poles,
across phi = 0 and under 4 members, at NSIDE 64 and 256, in float32 and
float64. K13 also takes a pixel's theta from its ring: the plain per-ring
angles equal pix2ang's bit for bit at NSIDE 64 and 256 (the card test
holds the kernel's at NSIDE 64, 256 and 1024).

K11 (the disc paint) walks the same flat layout. Its plain version over
that walk, ``paint.disc_paint_walk_plain``, must give the map of
``disc_paint_plain`` (to 1e-12 of the largest pixel: the sums run in
another order where discs overlap) and, in float64, the map of the JAX
``PaintProfilesShell._paint_device`` body (HealpixRunner.py:1948-1989,
written out with the JAX package's ``disc_candidates`` and
``TabulatedProfile.curve_lookup``) to tests/test_torch_paint.py's rtol
1e-9, at NSIDE 64 and 256, on the discs above plus one of more than
``SPLIT_RINGS`` rings and one with no member.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu.ops import fftlog as jf                # noqa: E402
from baryonforge_tpu.ops import healpix as jhpx             # noqa: E402
from baryonforge_tpu.utils.Tabulate import (                # noqa: E402
    TabulatedProfile as JTabulated)
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import deposit                   # noqa: E402
from baryonforge_torch.ops import fftlog as tf              # noqa: E402
from baryonforge_torch.ops import paint                     # noqa: E402

from defaults import COSMO_DICT                             # noqa: E402
from test_torch_anis import KW, catalog                     # noqa: E402
from test_torch_integrate_interp import close               # noqa: E402

# the H100's opt-in shared memory a block (bytes)
H100_SMEM = 232448


@pytest.mark.parametrize("N,route", [
    (2, (2, False, True)), (100, (256, True, True)),
    (1024, (1024, False, True)), (2048, (2048, False, True)),
    (2049, (8192, True, False)), (3000, (8192, True, False)),
    (4096, (4096, False, True)), (8192, (8192, False, False)),
    (12288, (32768, True, False)), (16384, (16384, False, False)),
    (20000, (65536, True, False)), (32768, (32768, False, False)),
    ((1 << 26) - 1, (1 << 27, True, False)),
    (1 << 27, (1 << 27, False, False))])
def test_fht_plan_routes(N, route):
    """A power of two runs its own FFT in 4 M doubles, any other N
    Bluestein's of the least power of two M >= 2 N - 1 in 6 M; shared
    memory holds M <= 4096 (power of two) or M <= 4096 with Bluestein
    (N <= 2048) of the H100's 232,448 bytes; longer rows run in the passes
    over device memory (ops.fftlog.fht_passes), whatever their M."""
    plan = tf.fht_plan(N, H100_SMEM)
    M, bluestein, in_shared = route
    assert plan[:3] == route
    assert M & (M - 1) == 0
    assert M >= 2 * N - 1 if bluestein else M == N
    assert in_shared == ((6 if bluestein else 4) * M * 8 <= H100_SMEM)
    assert plan.passes == (() if in_shared else tf.fht_passes(M))


@pytest.mark.parametrize("N", [(1 << 26) + 1, 1 << 28])
def test_fht_kernel_refuses_rows_past_its_longest_fft(N, monkeypatch):
    """K8's wrapper has no longest FFT: its only refusal is MemoryError,
    when the pass route's scratch (16 M bytes a row, 16 M more for
    Bluestein's chirp) and the call's own tensors do not fit the free
    memory (here 4 GiB, monkeypatched). It raises before it builds,
    allocates or launches anything, from the shapes and the free memory
    alone (the rows here are broadcast views: such a row would take 2 to 4
    GiB); the CPU's plain version takes any N."""
    x = torch.ones(1, dtype=torch.float64).expand(N)
    monkeypatch.setattr(tf, "_free_bytes", lambda device, need=0: 4 << 30)
    with pytest.raises(MemoryError, match="device-memory scratch"):
        tf._fht_kernel(x, x[None], 0.5, -0.5, 0.0, smem_bytes=H100_SMEM)


@pytest.mark.parametrize("N", [2048, 3000])
@pytest.mark.parametrize("mu,q", [(0.5, -0.5), (0.0, -1.0)])
def test_fht_plain_matches_jax_at_route_lengths(N, mu, q):
    """(0, -1) puts q on a Gamma pole, nudged by both packages."""
    rng = np.random.default_rng(N)
    x = np.geomspace(1e-4, 1e3, N)
    a = np.exp(-x[None] * rng.uniform(0.5, 2.0, (2, 1))) * x ** 0.5
    kt, at = tf.fht(torch.as_tensor(x), torch.as_tensor(a), mu, q)
    for b in range(2):
        kj, aj = jf.fht(jnp.asarray(x), jnp.asarray(a[b]), mu, q)
        close(kt, kj)
        close(at[b], aj)


def _halos(nside):
    """The Anis test catalog's discs (epsilon_max 20, R200c over the
    angular diameter distance, as the runners' _host_halo_data), with
    discs through each pole, across phi = 0 from either side and under 4
    members."""
    cols, _ = catalog()
    cosmo = bf.cosmo.cosmology_from_dict(COSMO_DICT)
    a = 1.0 / (1.0 + cols["z"])
    R = bf.cosmo.MassDef200c.get_radius(cosmo, cols["M"], a).numpy()
    D = bf.cosmo.angular_diameter_distance(cosmo, a).numpy()
    theta = np.radians(90.0 - cols["dec"])
    phi = np.radians(cols["ra"])
    radius = R * KW["epsilon_max"] / D
    pix = np.pi / (2 * nside)
    for i, th, ph, rad in ((0, 0.2 * pix, 1.0, 2.5 * pix),
                           (1, np.pi - 0.3 * pix, 3.0, 3.0 * pix),
                           (2, None, 0.2 * pix, None),
                           (3, None, 2 * np.pi - 0.4 * pix, None),
                           (4, 1.3, 0.7, 0.3 * pix), (5, 2.2, 5.1, 0.6 * pix)):
        if th is not None:
            theta[i] = th
        phi[i] = ph
        if rad is not None:
            radius[i] = rad
    return theta, phi, radius


def _pairs(halo, pix):
    h, p = np.asarray(halo, np.int64), np.asarray(pix, np.int64)
    return np.unique(h * (1 << 32) + p)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("nside", [64, 256])
def test_flat_walk_members_match_jax(nside, dt):
    theta, phi, radius = _halos(nside)
    jdt = {"f64": jnp.float64, "f32": jnp.float32}[dt]
    K_ring, K_phi = jhpx.disc_pad_sizes(nside, float(radius.max()))
    pix, mask = jax.vmap(lambda t, p, r: jhpx.disc_pixels(
        nside, t, p, r, K_ring, K_phi, jdt))(jnp.asarray(theta),
                                             jnp.asarray(phi),
                                             jnp.asarray(radius))
    pix, mask = np.asarray(pix), np.asarray(mask)
    halo = np.broadcast_to(np.arange(theta.size)[:, None], pix.shape)
    want = _pairs(halo[mask], pix[mask])
    w = deposit.disc_walk_plain(
        nside, torch.as_tensor(theta), torch.as_tensor(phi),
        torch.as_tensor(radius),
        {"f64": torch.float64, "f32": torch.float32}[dt])
    m = w["member"]
    got = _pairs(w["halo"][m], w["pix"][m])
    assert w["member"].sum() == got.size            # no pixel twice
    np.testing.assert_array_equal(got, want)
    counts = np.bincount(halo[mask], minlength=theta.size)
    assert (counts < 4).any() and (counts > 4).any()


@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("nside", [64, 256])
def test_ring_angles_are_pix2ang_plain(nside, dt):
    tr, pr = paint.pixel_angles(nside, dt, "cpu", per_ring=True)
    tp, pp = paint.pixel_angles(nside, dt, "cpu", per_ring=False)
    assert torch.equal(tr, tp) and torch.equal(pr, pp)
    assert tr.numel() == 12 * nside * nside
    # the belt's last pixel sits at 2 pi - pi / (4 N)
    assert math.isclose(float(pr.max()), 2 * math.pi - math.pi / (4 * nside),
                        rel_tol=1e-6)


def _paint_discs(nside):
    """_halos' discs, one of more than SPLIT_RINGS rings and one that
    holds no pixel centre, with D, a and log curves made from a seed: D
    puts each disc's edge near the curves' largest radius."""
    theta, phi, radius = _halos(nside)
    belt = hpx_ring_theta(nside, [2 * nside, 2 * nside + 1])
    theta = np.append(theta, [1.2, belt.mean()])
    phi = np.append(phi, [2.0, 0.0])
    radius = np.append(radius, [13.0 / nside, 0.05 * np.pi / (2 * nside)])
    rng = np.random.default_rng(nside)
    n, n_r = theta.size, 40
    ln_r0, dlnr = np.log(1e-3), np.log(1e4) / (n_r - 1)
    a = rng.uniform(0.7, 0.9, n)
    D = a * np.exp(ln_r0 + (n_r - 3) * dlnr) / (2 * np.sin(radius / 2))
    lnr = ln_r0 + dlnr * np.arange(n_r)
    curves = (rng.uniform(-1, 1, (n, 1)) - rng.uniform(1, 3, (n, 1)) * lnr
              + 0.1 * rng.standard_normal((n, n_r)))
    return (dict(theta=theta, phi=phi, radius=radius, D=D, a=a), curves,
            float(ln_r0), float(dlnr))


def hpx_ring_theta(nside, rings):
    return np.asarray(jhpx.ring_theta(nside, jnp.asarray(rings, jnp.int32),
                                      jnp.float64))


def _jax_paint_body(nside, h, curves, ln_r0, dlnr, pixel_size):
    """The JAX scatter paint's one_halo / body under x64, float64, with
    log curves, every halo in one batch."""
    npix = 12 * nside ** 2
    pixarea = 4 * np.pi / npix
    K_ring, K_phi = jhpx.disc_pad_sizes(nside, float(h["radius"].max()))

    def one_halo(th, ph, rad, D, a, c):
        pix, _, _, _, sinhd, mask = jhpx.disc_candidates(
            nside, th, ph, rad, K_ring, K_phi, jnp.float64)
        r_com = 2.0 * sinhd * D / a
        paint = JTabulated.curve_lookup(c, ln_r0, dlnr, r_com) / a
        paint = jnp.where(jnp.isfinite(paint), paint, 0.0)
        if pixel_size:
            paint = paint * (pixarea * D ** 2)
        return jnp.where(mask, pix, npix), jnp.where(mask, paint, 0.0)

    @jax.jit
    def body(*cols):
        pix, paint = jax.vmap(one_halo)(*cols)
        acc = jnp.zeros(npix + 1).at[pix.reshape(-1)].add(paint.reshape(-1))
        return acc[:npix]

    return np.asarray(body(*(jnp.asarray(h[k]) for k in (
        "theta", "phi", "radius", "D", "a")), jnp.asarray(curves)))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("nside", [64, 256])
def test_disc_paint_walk_matches_plain_and_jax(nside, dt):
    h, curves, ln_r0, dlnr = _paint_discs(nside)
    tdt = {"f64": torch.float64, "f32": torch.float32}[dt]
    halos = {k: torch.as_tensor(v) for k, v in h.items()}
    c = torch.as_tensor(curves, dtype=tdt)
    w = deposit.disc_walk_plain(nside, halos["theta"], halos["phi"],
                                halos["radius"], tdt)
    members = torch.bincount(w["halo"][w["member"]],
                             minlength=curves.shape[0])
    assert w["block"][-2] and not w["block"].all()
    assert members[-1] == 0 and (members[:-1] > 0).all()
    for pix in (False, True):
        got = paint.disc_paint_walk_plain(nside, halos, c, ln_r0, dlnr,
                                          True, pix, torch.float64)
        want = paint.disc_paint_plain(nside, halos, c, ln_r0, dlnr, True,
                                      pix, torch.float64)
        assert want.max() > 0 and (want > 0).sum() > 500
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-12 * want.max().item())
        assert torch.equal(got != 0, want != 0)
        if dt == "f64":
            j = _jax_paint_body(nside, h, curves, ln_r0, dlnr, pix)
            np.testing.assert_allclose(got.numpy(), j, rtol=1e-9,
                                       atol=1e-12 * j.max())
