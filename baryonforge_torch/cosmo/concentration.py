"""Concentration-mass relations and their remapping to other mass
definitions (port of ``baryonforge_tpu.cosmo.concentration``).

Each relation is a small frozen dataclass carrying its native mass
definition; calling it with (cosmo, M, a) gives c(M) as a float64 tensor
on M's device (the CPU for numbers and numpy arrays).
"""

import math
from dataclasses import dataclass

import torch

from . import core, power, massdef
from ..ops.interp import interp

__all__ = ["ConcentrationConstant", "ConcentrationDiemer15",
           "ConcentrationDuffy08", "ConcentrationBhattacharya13",
           "ConcentrationPrada12", "ConcentrationKlypin11",
           "ConcentrationIshiyama21", "GenericConcentration"]

_DELTA_C = 1.68647


@dataclass(frozen=True)
class _ConcentrationBase:
    mass_def: massdef.MassDef = massdef.MassDef200c

    def __call__(self, cosmo, M, a):
        return self._concentration(cosmo, torch.atleast_1d(core._f64(M)), a)


@dataclass(frozen=True)
class ConcentrationConstant(_ConcentrationBase):
    c: float = 5.0

    def _concentration(self, cosmo, M, a):
        return torch.full(M.shape, float(self.c), dtype=torch.float64,
                          device=M.device)


@dataclass(frozen=True)
class ConcentrationDiemer15(_ConcentrationBase):
    """Diemer & Kravtsov 2015 (median) for 200c:
    c = 0.5 c_min [(nu_min/nu)^alpha + (nu/nu_min)^beta], floor and scale
    set by the local slope n = dlnP/dlnk at kappa 2 pi / R_L."""
    kappa: float = 1.0
    phi_0: float = 6.58
    phi_1: float = 1.27
    eta_0: float = 7.28
    eta_1: float = 1.56
    alpha: float = 1.08
    beta: float = 1.77

    def _concentration(self, cosmo, M, a):
        R_L = power.lagrangian_radius(cosmo, M)
        k_R = 2.0 * math.pi / R_L * self.kappa
        n = power.dlnP_dlnk(cosmo, k_R)
        nu = _DELTA_C / power.sigmaM(cosmo, M, a)
        floor = self.phi_0 + n * self.phi_1
        nu0 = self.eta_0 + n * self.eta_1
        return 0.5 * floor * ((nu0 / nu) ** self.alpha
                              + (nu / nu0) ** self.beta)


@dataclass(frozen=True)
class ConcentrationDuffy08(_ConcentrationBase):
    """Duffy et al. 2008 power law; full-sample 200c calibration."""
    A: float = 5.71
    B: float = -0.084
    C: float = -0.47

    def _concentration(self, cosmo, M, a):
        M_piv = 2e12 / cosmo.h
        return self.A * (M / M_piv) ** self.B * a ** (-self.C)


@dataclass(frozen=True)
class ConcentrationBhattacharya13(_ConcentrationBase):
    """Bhattacharya et al. 2013, 200c calibration (full sample)."""
    A: float = 5.9
    B: float = 0.54
    C: float = -0.35

    def _concentration(self, cosmo, M, a):
        D = core.growth_factor(cosmo, core._f64(a).to(M.device))
        nu = _DELTA_C / power.sigmaM(cosmo, M, a)
        return self.A * D.squeeze() ** self.B * nu ** self.C


@dataclass(frozen=True)
class ConcentrationKlypin11(_ConcentrationBase):
    """Klypin et al. 2011 (Bolshoi, z=0 relation, virial masses)."""

    def _concentration(self, cosmo, M, a):
        M_piv = 1e12 / cosmo.h
        return 9.6 * (M / M_piv) ** -0.075


@dataclass(frozen=True)
class ConcentrationPrada12(_ConcentrationBase):
    """Prada et al. 2012 for 200c."""

    def _concentration(self, cosmo, M, a):
        sig = power.sigmaM(cosmo, M, a)
        x = core._f64(a).to(M.device) \
            * (cosmo.Omega_de / cosmo.Omega_m) ** (1.0 / 3.0)

        def _cmin(x0, v0, v1, x1):
            return v0 + (v1 - v0) * (torch.arctan(x1 * (x - x0)) / math.pi
                                     + 0.5)

        cmin = _cmin(1.393, 3.681, 5.033, 6.948)
        smin = _cmin(1.393, 1.047, 1.646, 7.386)
        # B0 = cmin(x)/cmin(1.393), B1 = smin(x)/smin(1.393)
        x_ref = 1.393
        cmin_ref = 3.681 + (5.033 - 3.681) * (
            math.atan(6.948 * (x_ref - 1.393)) / math.pi + 0.5)
        smin_ref = 1.047 + (1.646 - 1.047) * (
            math.atan(7.386 * (x_ref - 1.393)) / math.pi + 0.5)
        B0 = cmin / cmin_ref
        B1 = smin / smin_ref
        sp = B1 * sig
        C = 2.881 * ((sp / 1.257) ** 1.022 + 1.0) * torch.exp(0.060 / sp ** 2)
        return B0 * C


@dataclass(frozen=True)
class ConcentrationIshiyama21(_ConcentrationBase):
    """Ishiyama et al. 2021 (Uchuu), 200c fit (all halos): the JAX
    package's power-law-in-nu form, inverted by 20 fixed iterations."""
    kappa: float = 1.10
    a0: float = 2.30
    a1: float = 1.64
    b0: float = 1.72
    b1: float = 3.60
    c_alpha: float = 0.32

    def _concentration(self, cosmo, M, a):
        R_L = power.lagrangian_radius(cosmo, M)
        k_R = 2.0 * math.pi / R_L * self.kappa
        n = power.dlnP_dlnk(cosmo, k_R)
        nu = _DELTA_C / power.sigmaM(cosmo, M, a)
        A_n = self.a0 * (1.0 + self.a1 * (n + 3.0))
        B_n = self.b0 * (1.0 + self.b1 * (n + 3.0))
        C_n = 1.0 - self.c_alpha * (n + 3.0)
        G = nu / A_n * (1.0 + nu ** 2 / B_n)
        c = torch.full(nu.shape, 5.0, dtype=torch.float64, device=nu.device)
        expo = (5.0 + n) / 6.0
        for _ in range(20):
            c = G * massdef.nfw_mu(c) ** expo * C_n
            c = torch.clamp(c, 0.1, 100.0)
        return c


@dataclass(frozen=True)
class GenericConcentration:
    """Remap a native-definition c(M) relation to another mass definition,
    keeping the NFW scale radius (reference utils/concentration.py:97-149):
    a log-M grid in the native definition is translated to the target one,
    and log c_target is interpolated in log M_target."""
    base: object
    mass_def: massdef.MassDef = massdef.MassDef200c
    n_grid: int = 128

    def __call__(self, cosmo, M, a):
        from ..ops.grids import jnp_geomspace
        M = torch.atleast_1d(core._f64(M))
        M_nat = torch.as_tensor(jnp_geomspace(1e8, 1e18, self.n_grid),
                                device=M.device)
        c_nat = self.base(cosmo, M_nat, a)
        M_tgt, c_tgt = massdef.translate_mass(
            cosmo, M_nat, a, c_nat, self.base.mass_def, self.mass_def)
        return torch.exp(interp(torch.log(M), torch.log(M_tgt),
                                torch.log(c_tgt)))


def _make_remapper(base_cls, name):
    """A named cross-definition remapper (reference concentration.py:
    156-189): e.g. ``Duffy08(mass_def=MassDef200m)`` evaluates the native
    Duffy08 relation and remaps it to 200m, keeping r_s."""

    def __init__(self, mass_def=massdef.MassDef200c, **kw):
        object.__setattr__(self, "base", base_cls(**kw))
        object.__setattr__(self, "mass_def", mass_def)
        object.__setattr__(self, "n_grid", 128)

    cls = type(name, (GenericConcentration,), {"__init__": __init__})
    cls.__doc__ = (f"{name} concentration remapped to an arbitrary mass "
                   "definition (r_s-preserving).")
    return cls


Duffy08 = _make_remapper(ConcentrationDuffy08, "Duffy08")
Klypin11 = _make_remapper(ConcentrationKlypin11, "Klypin11")
Prada12 = _make_remapper(ConcentrationPrada12, "Prada12")
Diemer15 = _make_remapper(ConcentrationDiemer15, "Diemer15")
Bhattacharya13 = _make_remapper(ConcentrationBhattacharya13,
                                "Bhattacharya13")
Ishiyama21 = _make_remapper(ConcentrationIshiyama21, "Ishiyama21")

__all__ += ["Duffy08", "Klypin11", "Prada12", "Diemer15",
            "Bhattacharya13", "Ishiyama21"]
