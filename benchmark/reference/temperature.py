"""The gas number density and temperature on Schneider19 components: n =
rho_gas / (mu m_p), T = P / (n k_B), the projected T a ratio of the two
projections (a column-weighted temperature).

A copy of ``GasNumberDensity`` and ``Temperature`` in
``baryonforge_torch/Profiles/Thermodynamic.py`` at the commit that added the
configuration ``anis_paint``, in plain PyTorch: the benchmark's reference,
which imports nothing of the program and is not edited with it. One
departure: ``Temperature`` takes its pressure and number density as given
(the program's default pressure carries a non-thermal fraction, which this
reference does not hold; the configuration gives both).
"""

import torch

from . import constants as const
from .schneider19 import Gas
from .thermodynamic import BaseThermodynamicProfile

__all__ = ["GasNumberDensity", "Temperature"]


def _atleast_2d(x):
    return x if x.dim() >= 2 else x.reshape(1, -1)


class GasNumberDensity(BaseThermodynamicProfile):
    """n = rho_gas / (mu m_p) in 1/cm^3 (reference Thermodynamic.py:450)."""

    def __init__(self, gas=None, **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        super().__init__(**kwargs)
        self.prof4params = self.Gas
        mu = kwargs.get("mean_molecular_weight",
                        const.MEAN_MOLECULAR_WEIGHT)
        self.mean_molecular_weight = mu
        self.factor = (const.Msun_to_g / const.Mpc_to_cm ** 3
                       / (mu * const.M_PROTON_CGS))

    def _real(self, cosmo, r_use, M_use, a):
        return self.Gas._real(cosmo, r_use, M_use, a) * self.factor

    def _projected(self, cosmo, r, M, a, **kw):
        return self.Gas._projected(cosmo, r, M, a, **kw) * self.factor


class Temperature(BaseThermodynamicProfile):
    """T = P / (n k_B), real and projected (projected is a ratio of
    projections; reference Thermodynamic.py:516-647)."""

    def __init__(self, pressure, gasnumberdensity, **kwargs):
        self.Pressure = pressure
        self.GasNumberDensity = gasnumberdensity
        super().__init__(**kwargs)
        self.prof4params = getattr(self.Pressure, "prof4params",
                                   getattr(self.GasNumberDensity,
                                           "prof4params", self))

    @staticmethod
    def _ratio(P, n):
        P, n = _atleast_2d(P), _atleast_2d(n)
        return torch.where(n > 0, P / (n * const.K_BOLTZ_CGS),
                           torch.zeros_like(P))

    def _real(self, cosmo, r_use, M_use, a):
        return self._ratio(self.Pressure._real(cosmo, r_use, M_use, a),
                           self.GasNumberDensity._real(cosmo, r_use, M_use,
                                                       a))

    def _projected(self, cosmo, r, M, a, **kw):
        return self._ratio(
            self.Pressure._projected(cosmo, r, M, a, **kw),
            self.GasNumberDensity._projected(cosmo, r, M, a, **kw))
