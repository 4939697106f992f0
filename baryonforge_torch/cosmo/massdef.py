"""Spherical-overdensity mass definitions and the NFW mass translation
(port of ``baryonforge_tpu.cosmo.massdef``), in float64."""

import math
from dataclasses import dataclass

import torch

from . import core

__all__ = ["MassDef", "MassDef200c", "MassDef200m", "MassDef500c",
           "nfw_mu", "translate_mass"]


@dataclass(frozen=True)
class MassDef:
    """Overdensity mass definition: M = (4/3) pi Delta rho_type(a) R^3."""
    Delta: float
    rho_type: str          # 'critical' or 'matter'

    @property
    def name(self):
        return f"{int(self.Delta)}{self.rho_type[0]}"

    def get_Delta(self, cosmo=None, a=None):
        return self.Delta

    def _rho(self, cosmo, a):
        if self.rho_type == "critical":
            return core.rho_crit(cosmo, a)
        elif self.rho_type == "matter":
            return core.rho_x(cosmo, a, "matter", is_comoving=False)
        raise ValueError(f"unknown rho_type {self.rho_type}")

    def get_radius(self, cosmo, M, a):
        """Physical halo radius in Mpc (ccl get_radius convention), f64."""
        rho = self._rho(cosmo, a)
        return (3.0 * core._f64(M) / (4.0 * math.pi * self.Delta * rho)) \
            ** (1.0 / 3.0)

    def get_mass(self, cosmo, R, a):
        """Inverse of get_radius: mass enclosed in physical radius R."""
        rho = self._rho(cosmo, a)
        return 4.0 / 3.0 * math.pi * self.Delta * rho * core._f64(R) ** 3


MassDef200c = MassDef(200, "critical")
MassDef200m = MassDef(200, "matter")
MassDef500c = MassDef(500, "critical")


def nfw_mu(c):
    """NFW dimensionless enclosed mass mu(c) = ln(1+c) - c/(1+c)."""
    return torch.log1p(c) - c / (1.0 + c)


def translate_mass(cosmo, M1, a, c1, mdef_in, mdef_out, n_iter=40):
    """Translate halo masses between SO definitions for an NFW profile of
    concentration ``c1`` in the input definition: solves
    Delta2 rho2 R2^3 = Delta1 rho1 R1^3 mu(c1 R2/R1) / mu(c1) for R2 by
    ``n_iter`` geometric bisection steps. Returns (M2, c2)."""
    M1 = core._f64(M1)
    c1 = core._f64(c1).to(M1.device)
    R1 = mdef_in.get_radius(cosmo, M1, a)
    rho1 = mdef_in._rho(cosmo, a) * mdef_in.Delta
    rho2 = mdef_out._rho(cosmo, a) * mdef_out.Delta
    if isinstance(rho1, torch.Tensor):
        rho1, rho2 = rho1.to(M1.device), rho2.to(M1.device)

    def f(x):
        return rho2 * x ** 3 - rho1 * nfw_mu(c1 * x) / nfw_mu(c1)

    lo = torch.full(M1.shape, 1e-3, dtype=torch.float64, device=M1.device)
    hi = torch.full(M1.shape, 1e3, dtype=torch.float64, device=M1.device)
    for _ in range(n_iter):
        mid = torch.sqrt(lo * hi)
        take_hi = f(mid) > 0.0          # f increases with x
        lo, hi = torch.where(take_hi, lo, mid), torch.where(take_hi, mid, hi)
    x = torch.sqrt(lo * hi)
    M2 = mdef_out.get_mass(cosmo, x * R1.to(M1.device), a)
    return M2, c1 * x
