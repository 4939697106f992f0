"""Scatter regrid of the torch port (plain version of kernel K3) against
the JAX runner's ``_phase_b``, jitted as the runner jits it.

Offsets come from the JAX scatter phase A on the bench-like catalog, plus
a pole-overshoot case that pushes polar pixels through the pole.
"""

import math
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu.Runners.HealpixRunner import \
    BaryonifyShell as JBaryonifyShell                       # noqa: E402
from baryonforge_tpu.ops import healpix as jhp             # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import healpix as thp           # noqa: E402
from baryonforge_torch.ops.regrid import (regrid,           # noqa: E402
                                          displaced_weights)

from test_torch_curves import jax_model                     # noqa: E402
from test_torch_deposit import make_inputs, jax_phase_a    # noqa: E402


def jax_regrid(nside, po, orig, jdt):
    npix = 12 * nside ** 2
    ang = jnp.stack(jhp.pix2ang(nside, jnp.arange(npix, dtype=jnp.int32),
                                jdt), axis=1)
    fn = jax.jit(partial(JBaryonifyShell._phase_b, nside, npix, jdt))
    return np.asarray(fn(ang, jnp.asarray(po), jnp.asarray(orig, jdt)))


def pole_offsets(nside, rng):
    """Offsets that carry the first and last cap rings' pixels across the
    pole (theta < 0 and theta > pi after the move), zero elsewhere."""
    npix = 12 * nside ** 2
    po = np.zeros((npix, 2), np.float32)
    theta, _ = thp.pix2ang(nside, torch.arange(npix, dtype=torch.int32))
    theta = theta.numpy()
    north = np.where(theta < 3.0 / nside)[0]
    south = np.where(theta > np.pi - 3.0 / nside)[0]
    po[north, 0] = -theta[north] * rng.uniform(1.2, 2.5, north.size)
    po[south, 0] = (np.pi - theta[south]) * rng.uniform(1.2, 2.5, south.size)
    po[north, 1] = rng.normal(0, 1e-3, north.size)
    po[south, 1] = rng.normal(0, 1e-3, south.size)
    return po


def _offsets(case, nside):
    rng = np.random.default_rng(21)
    orig = rng.exponential(1.0, 12 * nside ** 2)
    if case == "pole":
        return pole_offsets(nside, rng), orig
    cat, shell = make_inputs(nside, 200, low_mass=True)
    po = jax_phase_a(cat, shell, jax_model(), jnp.float32)[0]
    return po, np.asarray(shell.map)


CASES = [("halos", 64), ("halos", 256), ("pole", 64)]
CASE_IDS = ["halos-nside64", "halos-nside256", "pole-nside64"]


@pytest.mark.parametrize("case,nside", CASES, ids=CASE_IDS)
def test_regrid_f64_matches_jax(case, nside):
    """float64 regrid: atol 1e-9 of the largest pixel change (the JAX
    package's stencil-vs-scatter bound, tests/test_tiled_deposit.py:80;
    only the summation order differs). Mass is conserved to rtol 1e-10 and
    unmoved pixels that receive nothing else keep their value bit for
    bit."""
    po, orig = _offsets(case, nside)
    ref = jax_regrid(nside, po, orig, jnp.float64)
    _build.reset_launches()
    out = regrid(nside, torch.tensor(po), torch.tensor(orig)).numpy()
    assert not _build.launches        # CPU tensors: the plain version
    scale = np.abs(ref - orig).max()
    assert scale > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(out.sum(), orig.sum(), rtol=1e-10)

    npix = po.shape[0]
    p = torch.arange(npix, dtype=torch.int32)
    theta_p, phi_p = thp.pix2ang(nside, p)
    cpix, _ = displaced_weights(nside, torch.float64, p, torch.tensor(po),
                                theta_p, phi_p)
    moved = (po != 0).any(axis=1)
    hit = np.zeros(npix, bool)
    hit[cpix.numpy()[moved].ravel()] = True
    quiet = ~moved & ~hit
    assert quiet.sum() > 0
    np.testing.assert_array_equal(out[quiet], orig[quiet])


@pytest.mark.parametrize("case,nside", CASES, ids=CASE_IDS)
def test_regrid_f32_matches_jax(case, nside):
    """float32 regrid (the bench's): the weights carry ~1e-6 * nside of
    float32 noise in either package (see test_torch_healpix), so pixels
    agree to that times the largest source value; mass is conserved to the
    float32 sum's rtol 1e-5 (the reference's np.isclose)."""
    po, orig = _offsets(case, nside)
    ref = jax_regrid(nside, po, orig, jnp.float32)
    out = regrid(nside, torch.tensor(po),
                 torch.tensor(orig).float()).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=4e-6 * nside * orig.max())
    np.testing.assert_allclose(out.sum(dtype=np.float64), orig.sum(),
                               rtol=1e-5)


def test_pole_reflection_lands_across_the_pole():
    """A pixel pushed through the north pole lands on the far side:
    theta reflected, phi turned by pi."""
    nside = 16
    npix = 12 * nside ** 2
    po = np.zeros((npix, 2), np.float64)
    po[0, 0] = -0.2                       # pixel 0: theta ~0.05, phi ~pi/4
    orig = np.zeros(npix)
    orig[0] = 1.0
    out = regrid(nside, torch.tensor(po), torch.tensor(orig)).numpy()
    theta0, phi0 = thp.pix2ang(nside, torch.tensor([0], dtype=torch.int32))
    dest = thp.ang2pix(nside, torch.abs(theta0 - 0.2), phi0 + math.pi)
    assert out.sum() == pytest.approx(1.0, rel=1e-12)
    assert out[int(dest)] == out.max()
    np.testing.assert_allclose(out, jax_regrid(nside, po, orig, jnp.float64),
                               atol=1e-12)


def test_regrid_rejects_bad_inputs():
    po = torch.zeros((12 * 16 * 16, 2))
    with pytest.raises(ValueError):
        regrid(16, po[:-1], torch.zeros(12 * 16 * 16))
    with pytest.raises(TypeError):
        regrid(16, po, torch.zeros(12 * 16 * 16, dtype=torch.int64))
    with pytest.raises(ValueError, match="NSIDE"):
        regrid(16384, po, torch.zeros(12 * 16 * 16))
