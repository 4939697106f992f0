"""FFTLog of the torch port (plain version of kernel K8 on the CPU) against
baryonforge_tpu.ops.fftlog: the complex log-gamma, the Hankel transform
fht for mu in {0, 1/2}, a bias q on a Gamma pole and N in {64, 100, 1024},
the physics wrappers and convolve_profile.

Tolerances: the plain version does its DFTs with torch.fft and native
complex128, the JAX package with matmuls of (re, im) pairs; the two agree
to ~1e-14 of the largest value (measured), held at 1e-12. The log-gamma
agrees to 1e-13 of its magnitude: its imaginary part reaches ~1e3 for
|Im z| ~ 300.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu.ops import fftlog as jf                # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import fftlog as tf              # noqa: E402

from test_torch_integrate_interp import close               # noqa: E402


def test_loggamma_matches_jax():
    rng = np.random.default_rng(0)
    z = (rng.uniform(-6, 6, 400) + 1j * rng.uniform(-320, 320, 400))
    z[:8] = [0.3, 2.5 + 1j, -1.5 + 0.3j, 0.7 + 250j, 0.2 - 240j, 0.5 + 0.9j,
             0.49 - 1.1j, 10.0 + 0j]
    j = np.asarray(jf.loggamma(jnp.asarray(z)))
    t = tf.loggamma(torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-13 * np.abs(j).max())
    assert (np.abs(z.imag) > 230).any() and np.isfinite(t).all()


def _row(x, rng, B=None):
    shape = (x.size,) if B is None else (B, x.size)
    return np.exp(-x * rng.uniform(0.5, 2.0, shape)) * x ** 0.5 \
        + rng.normal(0, 1e-3, shape) * np.exp(-x)


@pytest.mark.parametrize("N", [64, 100, 1024])
@pytest.mark.parametrize("mu,q", [(0.0, 0.0), (0.5, -0.5), (0.0, -0.5),
                                  (0.5, -1.5), (0.0, -1.0)])
def test_fht_matches_jax(N, mu, q):
    """(0, -1) puts (mu+1+q)/2 on the Gamma pole at 0: both packages nudge
    q by 1e-4."""
    rng = np.random.default_rng(N)
    x = np.geomspace(1e-4, 1e3, N)
    a = _row(x, rng)
    kj, aj = jf.fht(jnp.asarray(x), jnp.asarray(a), mu, q)
    _build.reset_launches()
    kt, at = tf.fht(torch.as_tensor(x), torch.as_tensor(a), mu, q)
    assert not _build.launches          # CPU: the plain version
    close(kt, kj)
    close(at, aj)


def test_fht_batch_and_kcrc():
    """A (B, N) batch transforms row by row; a tensor kcrc equals the
    number."""
    rng = np.random.default_rng(7)
    x = np.geomspace(1e-3, 1e2, 128)
    a = _row(x, rng, B=5)
    kt, at = tf.fht(torch.as_tensor(x), torch.as_tensor(a), 0.5, -0.5,
                    kcrc=2.0)
    kt2, at2 = tf.fht(torch.as_tensor(x), torch.as_tensor(a), 0.5, -0.5,
                      kcrc=torch.tensor(2.0, dtype=torch.float64))
    assert torch.equal(at, at2) and torch.equal(kt, kt2)
    for b in range(5):
        kj, aj = jf.fht(jnp.asarray(x), jnp.asarray(a[b]), 0.5, -0.5,
                        kcrc=2.0)
        close(kt, kj)
        close(at[b], aj)


@pytest.mark.parametrize("mu", [0.0, 0.5])
def test_fht_summation_orders(mu):
    """The spread between two correct summation orders of the DFTs, which
    sets K8's tolerance on the card: the JAX package's matmul DFT against
    torch.fft, on 20 DarkMatter rows times x^1.5 on a 2048-point grid over
    16 decades (chip_smoke.py's K8 batch). Each row is held against its own
    largest value; measured 2.2e-12 (mu = 0) and 1.2e-12 (mu = 1/2), over
    the 1e-12 first tried and under the 1e-11 the card is held to."""
    import baryonforge_torch as bf
    h = 0.7
    bpar = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / h, mu_beta=0.4,
                eta=0.3, eta_delta=0.3, tau=-1.5, tau_delta=0,
                A=0.09 / 2, M1=2.5e11 / h, epsilon_h=0.015,
                a=0.3, n=2, epsilon=4, p=0.3, q=0.707, gamma=2, delta=7)
    cosmo = bf.cosmo.cosmology_from_dict(dict(
        Omega_m=0.30, Omega_b=0.045, h=0.7, sigma8=0.8, n_s=0.96, w0=-1.0))
    x = torch.as_tensor(np.geomspace(1e-7, 1e9, 2048))
    M = torch.as_tensor(np.geomspace(5e12, 2e15, 20))
    a = bf.Profiles.DarkMatter(**bpar).real(cosmo, x, M, 1 / 1.7) * x ** 1.5
    _, at = tf.fht(x, a, mu, -0.5)
    _, aj = jf.fht(jnp.asarray(x.numpy()), jnp.asarray(a.numpy()), mu, -0.5)
    at = at.numpy()
    rel = (np.abs(at - np.asarray(aj)).max(1) / np.abs(at).max(1)).max()
    assert rel <= 1e-11, rel


def test_fftlog_wrappers_match_jax():
    rng = np.random.default_rng(8)
    r = np.geomspace(1e-3, 1e3, 256)
    f = 1.0 / (r * (1 + r) ** 2)
    k_out = np.geomspace(1e-2, 1e2, 40)
    R_out = np.geomspace(1e-2, 10, 30)
    for fj, ft, q in ((jf.sph_fourier_3d, tf.sph_fourier_3d, k_out),
                      (jf.sph_inverse_3d, tf.sph_inverse_3d, R_out),
                      (jf.proj_fourier_2d, tf.proj_fourier_2d, k_out),
                      (jf.proj_inverse_2d, tf.proj_inverse_2d, R_out)):
        close(ft(torch.as_tensor(r), torch.as_tensor(f), torch.as_tensor(q)),
              fj(jnp.asarray(r), jnp.asarray(f), jnp.asarray(q)))
    k = np.geomspace(1e-4, 1e2, 512)
    pk = k / (1 + (k / 0.02) ** 3) * (1 + 0.01 * rng.normal(size=k.size))
    close(tf.xi_from_pk(torch.as_tensor(k), torch.as_tensor(pk),
                        torch.as_tensor(R_out)),
          jf.xi_from_pk(jnp.asarray(k), jnp.asarray(pk), jnp.asarray(R_out)))


@pytest.mark.parametrize("dim", [2, 3])
def test_convolve_profile_matches_jax(dim):
    # an NFW-like r^-2 (1+r)^-2: the wrappers' default bias (plaw = -2)
    # suits it; far steeper profiles ring, and their round trip amplifies
    # rounding by orders of magnitude in either package
    r = np.geomspace(1e-3, 1e2, 256)
    f = 1.0 / (r ** 2 * (1 + r) ** 2)

    def wj(k):
        return jnp.exp(-(k * 0.05) ** 2)

    def wt(k):
        return torch.exp(-(k * 0.05) ** 2)

    j = jf.convolve_profile(jnp.asarray(r), jnp.asarray(f), wj, dim=dim)
    t = tf.convolve_profile(torch.as_tensor(r), torch.as_tensor(f), wt,
                            dim=dim)
    close(t, j)
    # a unit window too
    close(tf.convolve_profile(torch.as_tensor(r), torch.as_tensor(f),
                              torch.ones_like, dim=dim),
          jf.convolve_profile(jnp.asarray(r), jnp.asarray(f), jnp.ones_like,
                              dim=dim))


def test_padded_grid_and_safe_q():
    r = np.geomspace(0.01, 10, 30)
    np.testing.assert_array_equal(tf._padded_grid(r, 0.1, 10, 20),
                                  jf._padded_grid(r, 0.1, 10, 20))
    for mu, q in ((0.0, -1.0), (0.5, -1.5), (0.5, -3.5), (0.0, -0.5)):
        assert tf._safe_q(mu, q) == jf._safe_q(mu, q)
    assert tf._safe_q(0.0, -1.0) == -1.0 + 1e-4
    assert math.isclose(tf._safe_q(0.5, -3.5), -3.5 + 1e-4)


def test_fht_rejects_other_devices():
    x = torch.as_tensor(np.geomspace(1e-3, 1e3, 64))
    with pytest.raises(ValueError, match="device"):
        tf.fht(x.to("meta"), x.to("meta"), 0.5, -0.5)
