"""Cosmology core in torch float64: background expansion and distances.

Port of ``baryonforge_tpu.cosmo.core`` (flat w0waCDM with radiation) and
its linear growth factor. Every function takes a :class:`Cosmology` and a
scale factor (number, numpy array or tensor) and returns a float64 tensor
on the scale factor's device (CPU for numbers and numpy arrays).

A frozen copy of ``baryonforge_torch/cosmo/core.py`` at the commit that added
the benchmark: the benchmark's reference, which imports nothing of the
program and is not edited with it.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import constants as const

__all__ = ["Cosmology", "Eofa", "rho_crit", "rho_x",
           "comoving_radial_distance", "angular_diameter_distance",
           "growth_factor", "cosmology_from_dict"]


@dataclass(frozen=True)
class Cosmology:
    """Flat w0waCDM cosmology parameter set (reference cosmo-dict analog).

    Required keys mirror the reference's validated cosmo dict
    (utils/io.py:56-129): Omega_m, Omega_b, sigma8, h, n_s, w0 (+ wa).
    """
    Omega_m: float
    Omega_b: float
    h: float
    sigma8: float
    n_s: float
    w0: float = -1.0
    wa: float = 0.0
    T_CMB: float = 2.725
    Neff: float = 3.044

    @property
    def Omega_c(self):
        return self.Omega_m - self.Omega_b

    @property
    def Omega_g(self):
        # photon density from T_CMB:  Omega_g h^2 = 2.473e-5 (T/2.7255)^4
        return 2.47282e-5 * (self.T_CMB / 2.7255) ** 4 / self.h ** 2

    @property
    def Omega_nu_rel(self):
        return self.Omega_g * 0.2271073 * self.Neff

    @property
    def Omega_r(self):
        return self.Omega_g + self.Omega_nu_rel

    @property
    def Omega_de(self):
        return 1.0 - self.Omega_m - self.Omega_r


def cosmology_from_dict(d):
    """Build a Cosmology from the reference-style cosmo dict."""
    return Cosmology(Omega_m=float(d["Omega_m"]), Omega_b=float(d["Omega_b"]),
                     h=float(d["h"]), sigma8=float(d["sigma8"]),
                     n_s=float(d["n_s"]), w0=float(d.get("w0", -1.0)),
                     wa=float(d.get("wa", 0.0)))


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def Eofa(cosmo, a):
    """Dimensionless Hubble rate E(a) = H(a)/H0 for flat w0waCDM + radiation."""
    a = _f64(a)
    de = cosmo.Omega_de * a ** (-3.0 * (1.0 + cosmo.w0 + cosmo.wa)) \
        * torch.exp(-3.0 * cosmo.wa * (1.0 - a))
    return torch.sqrt(cosmo.Omega_m * a ** -3 + cosmo.Omega_r * a ** -4 + de)


def rho_crit(cosmo, a):
    """Critical density at scale factor a, physical Msun / Mpc^3."""
    return const.RHO_CRIT_0_h2 * cosmo.h ** 2 * Eofa(cosmo, a) ** 2


def rho_x(cosmo, a, species="matter", is_comoving=False):
    """Density of a species (reference ccl.rho_x analog), Msun / Mpc^3."""
    a = _f64(a)
    rc0 = const.RHO_CRIT_0_h2 * cosmo.h ** 2
    if species == "matter":
        rho0 = cosmo.Omega_m * rc0
        phys = rho0 * a ** -3
    elif species == "critical":
        phys = rho_crit(cosmo, a)
        rho0 = None
    elif species == "baryon":
        rho0 = cosmo.Omega_b * rc0
        phys = rho0 * a ** -3
    else:
        raise ValueError(f"unknown species {species}")
    if is_comoving:
        if rho0 is None:
            return phys * a ** 3
        return rho0 * torch.ones_like(a)
    return phys


# Distances (flat): chi(a) = (c/H0) ∫_a^1 da' / (a'^2 E(a')), the same
# 128-node Gauss-Legendre rule as the JAX package, vectorised over a.
_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(128)


def comoving_radial_distance(cosmo, a):
    """Comoving radial distance in Mpc (vectorised over a, at least 1-D)."""
    a = torch.atleast_1d(_f64(a))
    nodes = torch.as_tensor(_GL_NODES, device=a.device)
    weights = torch.as_tensor(_GL_WEIGHTS, device=a.device)
    lo, hi = a[..., None], 1.0
    x = 0.5 * (hi - lo) * (nodes + 1.0) + lo              # (..., 128)
    w = 0.5 * (hi - lo) * weights
    integrand = 1.0 / (x ** 2 * Eofa(cosmo, x))
    return (const.C_LIGHT / (100.0 * cosmo.h)) * torch.sum(w * integrand,
                                                           dim=-1)


def angular_diameter_distance(cosmo, a):
    """Angular-diameter distance D_A = a * chi (flat), physical Mpc."""
    a = torch.atleast_1d(_f64(a))
    return a * comoving_radial_distance(cosmo, a)


# ---------------------------------------------------------------------------
# Linear growth factor: the growth ODE in ln a, fixed-step RK4 from
# a = 1e-4, D'' + (2 + dlnE/dlna) D' - (3/2) Omega_m(a) D = 0 (' = d/dlna),
# normalised to D(1) = 1 (CCL's convention).
# ---------------------------------------------------------------------------
_GROWTH_N = 512
_GROWTH_LNA0 = math.log(1e-4)


def _Eofa_norad(cosmo, a):
    """E(a) without radiation, for the growth ODE only (its matter-era
    start D ~ a assumes no radiation)."""
    ode = 1.0 - cosmo.Omega_m
    de = ode * a ** (-3.0 * (1.0 + cosmo.w0 + cosmo.wa)) \
        * math.exp(-3.0 * cosmo.wa * (1.0 - a))
    return math.sqrt(cosmo.Omega_m * a ** -3 + de)


def _omega_m_of_a(cosmo, a):
    return cosmo.Omega_m * a ** -3 / _Eofa_norad(cosmo, a) ** 2


def _dlnE_dlna(cosmo, a):
    eps = 1e-4
    return (math.log(_Eofa_norad(cosmo, a * math.exp(eps)))
            - math.log(_Eofa_norad(cosmo, a * math.exp(-eps)))) / (2.0 * eps)


_growth_tables = {}


def _growth_table_host(cosmo):
    """(ln a grid, D grid) of the RK4 integration, float64 numpy. A
    sequence of 511 scalar steps, so it runs on the host, once per
    cosmology."""
    from .grids import jnp_linspace
    lna = jnp_linspace(_GROWTH_LNA0, 0.0, _GROWTH_N)
    dl = float(lna[1] - lna[0])

    def rhs(D, Dp, x):
        a = math.exp(x)
        damp = 2.0 + _dlnE_dlna(cosmo, a)
        return Dp, -damp * Dp + 1.5 * _omega_m_of_a(cosmo, a) * D

    a0 = math.exp(_GROWTH_LNA0)
    D, Dp = a0, a0
    out = [a0]
    # each step evaluates its stages from the END of its interval, ln a_i +
    # (0, dl/2, dl/2, dl): the JAX package's scan over lna[1:] does so
    for x in lna[1:]:
        x = float(x)
        k1 = rhs(D, Dp, x)
        k2 = rhs(D + 0.5 * dl * k1[0], Dp + 0.5 * dl * k1[1], x + 0.5 * dl)
        k3 = rhs(D + 0.5 * dl * k2[0], Dp + 0.5 * dl * k2[1], x + 0.5 * dl)
        k4 = rhs(D + dl * k3[0], Dp + dl * k3[1], x + dl)
        D = D + dl / 6.0 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        Dp = Dp + dl / 6.0 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        out.append(D)
    D = np.asarray(out)
    return lna, D / D[-1]


def _growth_table(cosmo, device):
    """The growth table as float64 tensors on ``device``, cached per
    cosmology and device."""
    key = (cosmo, str(device))
    if key not in _growth_tables:
        host = ("host", cosmo)
        if host not in _growth_tables:
            _growth_tables[host] = _growth_table_host(cosmo)
        lna, D = _growth_tables[host]
        _growth_tables[key] = (torch.as_tensor(lna, device=device),
                               torch.as_tensor(D, device=device))
    return _growth_tables[key]


def growth_factor(cosmo, a):
    """Linear growth D(a)/D(1); a scalar a gives a 0-d tensor."""
    from .interp import interp
    a_t = _f64(a)
    lna, D = _growth_table(cosmo, a_t.device)
    out = interp(torch.log(torch.atleast_1d(a_t)), lna, D)
    return out[0] if a_t.dim() == 0 else out
