"""Cosmology of the torch port against baryonforge_tpu.cosmo: the growth
factor, sigma8 normalisation, the linear power with all three transfer
functions, dlnP/dlnk, sigma(M), the FFTLog correlation function, every
concentration relation (native and remapped) and translate_mass.

Tolerance 1e-11 relative (with a floor at that fraction of the largest
value): the growth ODE runs on the host in Python floats in the port and
in XLA in the JAX package, and the transcendentals differ by an ulp; 511
RK4 steps and sigma8's integral keep that at ~1e-13 (measured).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import cosmo as jc                     # noqa: E402
from baryonforge_tpu.cosmo import concentration as jconc    # noqa: E402
from baryonforge_torch import cosmo as tc                   # noqa: E402
from baryonforge_torch.cosmo import concentration as tconc  # noqa: E402
from baryonforge_torch.cosmo import power as tpower         # noqa: E402
from baryonforge_tpu.cosmo import power as jpower           # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402

from test_torch_integrate_interp import close               # noqa: E402

RTOL = 1e-11
COSMOS = [dict(Omega_m=0.30, Omega_b=0.045, h=0.7, sigma8=0.8, n_s=0.96,
               w0=-1.0),
          dict(Omega_m=0.25, Omega_b=0.05, h=0.67, sigma8=0.83, n_s=0.97,
               w0=-0.9, wa=0.1)]
TRANSFERS = ["eisenstein_hu", "eisenstein_hu_nowiggles", "bbks"]


def both(d):
    return jc.cosmology_from_dict(d), tc.cosmology_from_dict(d)


@pytest.mark.parametrize("ci", [0, 1])
def test_growth_factor_matches_jax(ci):
    j, t = both(COSMOS[ci])
    a = np.linspace(0.05, 1.0, 60)
    close(tc.growth_factor(t, a), jc.growth_factor(j, jnp.asarray(a)),
          RTOL)
    g = tc.growth_factor(t, 0.5)
    assert g.dim() == 0
    close(g, jc.growth_factor(j, 0.5), RTOL)


@pytest.mark.parametrize("transfer", TRANSFERS)
@pytest.mark.parametrize("ci", [0, 1])
def test_linear_power_matches_jax(transfer, ci):
    j, t = both(COSMOS[ci])
    k = np.geomspace(1e-4, 50, 300)
    close(tpower.sigma8_norm(t, transfer), jpower.sigma8_norm(j, transfer),
          RTOL)
    for a in (1.0, 0.6):
        close(tc.linear_power(t, torch.as_tensor(k), a, transfer),
              jc.linear_power(j, jnp.asarray(k), a, transfer), RTOL)
    close(getattr(tpower, jpower._TRANSFERS[transfer].__name__)(t, k),
          jpower._TRANSFERS[transfer](j, jnp.asarray(k)), RTOL)


@pytest.mark.parametrize("ci", [0, 1])
def test_sigma_and_slope_match_jax(ci):
    j, t = both(COSMOS[ci])
    M = np.geomspace(1e11, 1e16, 40)
    for a in (1.0, 0.55):
        close(tc.sigmaM(t, torch.as_tensor(M), a),
              jc.sigmaM(j, jnp.asarray(M), a), RTOL)
    R = np.geomspace(0.5, 30, 20)
    close(tc.sigmaR(t, torch.as_tensor(R), 0.8),
          jc.sigmaR(j, jnp.asarray(R), 0.8), RTOL)
    close(tc.sigmaR(t, 8.0), jc.sigmaR(j, 8.0), RTOL)
    k = np.geomspace(1e-3, 10, 50)
    close(tc.dlnP_dlnk(t, torch.as_tensor(k)),
          jc.dlnP_dlnk(j, jnp.asarray(k)), RTOL)
    close(tc.lagrangian_radius(t, M), jc.lagrangian_radius(j, M), RTOL)


@pytest.mark.parametrize("ci", [0, 1])
def test_correlation_3d_matches_jax(ci):
    """xi(r) by FFTLog on the 1024-point K_GRID (the plain version of K8
    here: no launch on the CPU)."""
    j, t = both(COSMOS[ci])
    r = np.geomspace(1e-3, 150, 200)
    _build.reset_launches()
    xt = tc.correlation_3d(t, torch.as_tensor(r), 0.6)
    assert not _build.launches
    close(xt, jc.correlation_3d(j, jnp.asarray(r), 0.6), RTOL)
    np.testing.assert_array_equal(tpower.K_GRID, np.asarray(jpower.K_GRID))


NATIVE = ["ConcentrationDiemer15", "ConcentrationDuffy08",
          "ConcentrationBhattacharya13", "ConcentrationPrada12",
          "ConcentrationKlypin11", "ConcentrationIshiyama21"]


@pytest.mark.parametrize("name", NATIVE + ["ConcentrationConstant"])
def test_concentrations_match_jax(name):
    j, t = both(COSMOS[0])
    M = np.geomspace(1e12, 1e16, 25)
    for a in (1.0, 0.5):
        close(getattr(tconc, name)()(t, torch.as_tensor(M), a),
              getattr(jconc, name)()(j, jnp.asarray(M), a), RTOL)


@pytest.mark.parametrize("name", ["Duffy08", "Diemer15", "Klypin11"])
@pytest.mark.parametrize("md", ["MassDef200m", "MassDef500c"])
def test_remapped_concentrations_match_jax(name, md):
    j, t = both(COSMOS[0])
    M = np.geomspace(1e12, 1e15, 15)
    jr = getattr(jconc, name)(mass_def=getattr(jc, md))
    tr = getattr(tconc, name)(mass_def=getattr(tc, md))
    close(tr(t, torch.as_tensor(M), 0.7), jr(j, jnp.asarray(M), 0.7), RTOL)


def test_translate_mass_matches_jax():
    j, t = both(COSMOS[1])
    M = np.geomspace(1e12, 1e15, 20)
    c = np.linspace(3.0, 9.0, 20)
    for a, b in (("MassDef200c", "MassDef200m"),
                 ("MassDef500c", "MassDef200c")):
        Mj, cj = jc.translate_mass(j, jnp.asarray(M), 0.6, jnp.asarray(c),
                                   getattr(jc, a), getattr(jc, b))
        Mt, ct = tc.translate_mass(t, torch.as_tensor(M), 0.6,
                                   torch.as_tensor(c), getattr(tc, a),
                                   getattr(tc, b))
        close(Mt, Mj, RTOL)
        close(ct, cj, RTOL)
    close(tc.nfw_mu(torch.as_tensor(c)), jc.nfw_mu(jnp.asarray(c)), 1e-14)
