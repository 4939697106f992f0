"""HEALPix geometry of the torch port against baryonforge_tpu.ops.healpix.

Same numpy inputs (seeded) through both; integer outputs must be equal,
float64 outputs agree to rtol 1e-12 (with an absolute floor of 1e-12 of
the array's largest value, for entries that are differences near zero)
and float32 outputs to atol 2e-6: XLA's float32 sin/asin/acos differ from
torch's by a few ulp, and under jit XLA fuses a*b+c.

Interpolation weights in float32 are the exception. A weight is a
difference of angles divided by the ring or pixel spacing, so one ulp of
an angle (2.4e-7 near pi) moves it by ~1e-6 * nside: they agree to atol
1e-6 * nside (the JAX package documents ~1e-4 f32 weight noise at
NSIDE ~1k, ops/healpix.py:264-265).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu.ops import healpix as jhp             # noqa: E402
from baryonforge_torch.ops import healpix as thp           # noqa: E402

DTYPES = [(jnp.float64, torch.float64), (jnp.float32, torch.float32)]
DT_IDS = ["f64", "f32"]


def _close(t, j, tdt, atol32=2e-6):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    if np.issubdtype(j.dtype, np.integer) or j.dtype == bool:
        np.testing.assert_array_equal(t, j)
    elif tdt == torch.float64:
        np.testing.assert_allclose(t, j, rtol=1e-12,
                                   atol=1e-12 * np.abs(j).max())
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=atol32)


def _angles(nside, n=400, seed=0):
    """Random points plus cap, belt, cap-boundary and pole points."""
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(-2 * np.pi, 4 * np.pi, n)
    z_edge = np.arccos(2.0 / 3.0)
    special = np.array([1e-9, 1e-6, 0.5 / nside, z_edge, z_edge + 1e-7,
                        np.pi / 2, np.pi - z_edge, np.pi - 0.5 / nside,
                        np.pi - 1e-6, np.pi - 1e-9])
    theta = np.concatenate([theta, special, special])
    phi = np.concatenate([phi, np.zeros(special.size),
                          np.full(special.size, 2 * np.pi - 1e-9)])
    return theta, phi


@pytest.mark.parametrize("nside", [16, 64, 256])
def test_sizes_and_pad(nside):
    assert thp.npix(nside) == jhp.npix(nside)
    assert thp.nside2pixarea(nside) == jhp.nside2pixarea(nside)
    for r, s in [(0.01, 0.0), (0.05, 0.25), (0.2, 0.05)]:
        assert thp.disc_pad_sizes(nside, r, s) == jhp.disc_pad_sizes(
            nside, r, s)


@pytest.mark.parametrize("dts", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [16, 256])
def test_ring_functions(nside, dts):
    jdt, tdt = dts
    i = np.arange(1, 4 * nside, dtype=np.int32)
    for t, j in zip(thp.ring_info(nside, torch.as_tensor(i), tdt),
                    jhp.ring_info(nside, jnp.asarray(i), jdt)):
        _close(t, j, tdt)
    _close(thp.ring_theta(nside, torch.as_tensor(i), tdt),
           jhp.ring_theta(nside, jnp.asarray(i), jdt), tdt)
    theta, _ = _angles(nside)
    _close(thp.ring_above_theta(nside, torch.as_tensor(theta).to(tdt)),
           jhp.ring_above_theta(nside, jnp.asarray(theta, jdt)), tdt)


@pytest.mark.parametrize("dts", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [16, 256])
def test_pix2ang_ang2pix(nside, dts):
    jdt, tdt = dts
    rng = np.random.default_rng(1)
    npx = 12 * nside * nside
    p = np.concatenate([np.arange(min(npx, 4096)),
                        rng.integers(0, npx, 4000),
                        np.arange(max(npx - 4096, 0), npx)]).astype(np.int32)
    for t, j in zip(thp.pix2ang(nside, torch.as_tensor(p), tdt),
                    jhp.pix2ang(nside, jnp.asarray(p), jdt)):
        _close(t, j, tdt)
    theta, phi = _angles(nside)
    _close(thp.ang2pix(nside, torch.as_tensor(theta).to(tdt),
                       torch.as_tensor(phi).to(tdt)),
           jhp.ang2pix(nside, jnp.asarray(theta, jdt),
                       jnp.asarray(phi, jdt)), tdt)


@pytest.mark.parametrize("dts", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [16, 256])
@pytest.mark.parametrize("phi_dtype", ["f64", "same"])
def test_get_interp_weights(nside, dts, phi_dtype):
    """phi_dtype: float64 inputs (the deposit's fallback, where the wrap
    into [0, 2 pi) runs in float64) or inputs in the working dtype (the
    regrid)."""
    jdt, tdt = dts
    theta, phi = _angles(nside, seed=2)
    if phi_dtype == "f64":
        jt, jp = jnp.asarray(theta), jnp.asarray(phi)
        tt, tp = torch.as_tensor(theta), torch.as_tensor(phi)
    else:
        jt, jp = jnp.asarray(theta, jdt), jnp.asarray(phi, jdt)
        tt = torch.as_tensor(theta).to(tdt)
        tp = torch.as_tensor(phi).to(tdt)
    jpix, jw = jhp.get_interp_weights(nside, jt, jp, jdt)
    tpix, tw = thp.get_interp_weights(nside, tt, tp, tdt)
    _close(tpix, jpix, tdt)
    _close(tw, jw, tdt, atol32=1e-6 * nside)
    # weights sum to 1 (a float32 theta rounded past pi gives NaN in both)
    ok = np.isfinite(np.asarray(jw)).all(-1)
    assert ok.mean() > 0.95
    np.testing.assert_allclose(tw.sum(-1).numpy()[ok], 1.0,
                               atol=1e-12 if tdt == torch.float64 else 1e-5)


@pytest.mark.parametrize("dts", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [16, 256])
def test_disc_candidates(nside, dts):
    """Padded disc queries, including discs over a pole and discs larger
    than the small polar rings (the no-duplicate rule)."""
    jdt, tdt = dts
    theta, phi = _angles(nside, n=60, seed=3)
    rng = np.random.default_rng(4)
    radius = rng.uniform(0.2, 6.0, theta.size) * np.sqrt(
        thp.nside2pixarea(nside))
    K_ring, K_phi = thp.disc_pad_sizes(nside, float(radius.max()))
    fn = jax.vmap(lambda t, p, r: jhp.disc_candidates(
        nside, t, p, r, K_ring, K_phi, jdt))
    jout = fn(jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(radius))
    tout = thp.disc_candidates(nside, torch.as_tensor(theta),
                               torch.as_tensor(phi), torch.as_tensor(radius),
                               K_ring, K_phi, tdt)
    for t, j in zip(tout, jout):
        _close(t, j, tdt)
    mask = tout[5].numpy()
    assert mask.sum() > 0
    for row in range(mask.shape[0]):          # no pixel twice in a disc
        members = tout[0].numpy()[row][mask[row]]
        assert members.size == np.unique(members).size


@pytest.mark.parametrize("dt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_fmod_near_is_fmod(dt):
    """The exact remainder of kernels K4 and K16 (csrc/healpix.cuh:
    fmod_near, floor_fmod_near), in its plain version: bitwise torch.fmod
    and the floor remainder (torch.remainder, jnp.mod) at +-n, +-2n, their
    neighbours, +-0, and random values within and past +-3n, for the
    divisors K4 (2 pi) and K16 (a grid size) use."""
    rng = np.random.default_rng(11)
    ints = torch.int64 if dt == torch.float64 else torch.int32
    for n in (2 * np.pi, 256.0, 33.0):
        nn = torch.tensor(n, dtype=dt)
        edges = torch.stack([nn, -nn, 2 * nn, -2 * nn, 3 * nn, -3 * nn])
        up = torch.nextafter(edges, torch.full_like(edges, np.inf))
        down = torch.nextafter(edges, torch.full_like(edges, -np.inf))
        a = torch.cat([edges, up, down, torch.tensor([0.0, -0.0, 1e30,
                                                      -1e30], dtype=dt),
                       torch.as_tensor(rng.uniform(-3, 3, 20000) * n,
                                       dtype=dt),
                       torch.as_tensor(rng.uniform(-1e6, 1e6, 2000),
                                       dtype=dt)])
        want = torch.fmod(a, nn)
        got = thp.fmod_near(a, n)
        assert torch.equal(got.view(ints), want.view(ints))
        floor = torch.where((want != 0) & (want < 0), want + nn, want)
        got = thp.floor_fmod_near(a, n)
        assert torch.equal(got.view(ints), floor.view(ints))
        assert torch.equal(got.view(ints), torch.remainder(a, nn).view(ints))
        assert (torch.signbit(thp.fmod_near(-nn[None], n)).all()
                and torch.signbit(thp.fmod_near(torch.tensor([-0.0],
                                                             dtype=dt), n)))
