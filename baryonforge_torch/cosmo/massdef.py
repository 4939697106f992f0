"""Spherical-overdensity mass definitions (port of
``baryonforge_tpu.cosmo.massdef``). ``translate_mass`` is not ported yet
(ROADMAP Queue 1)."""

import math
from dataclasses import dataclass

from . import core

__all__ = ["MassDef", "MassDef200c", "MassDef200m", "MassDef500c"]


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
