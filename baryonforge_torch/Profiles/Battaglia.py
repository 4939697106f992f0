"""Battaglia et al. 2012 pressure and gas-density calibrations (port of
``baryonforge_tpu.Profiles.Battaglia``), plain torch in float64.

Calibrations '200_AGN' / '500_AGN' / '500_SH' for pressure and
'200_AGN' / '200_SH' for gas density, with the self-similar P_Delta
normalization (reference Battaglia.py:147-156); pressure in CGS.
"""

import torch

from .Base import Profile, _rows
from ..cosmo import core as _core
from ..cosmo import massdef as _massdef
from ..utils import constants as const

__all__ = ["Pressure", "ElectronPressure", "GasDensity"]

# (P_0, x_c, beta) power laws in M/1e14 and (1+z) per calibration
_PRESSURE_CAL = {
    "200_AGN": dict(P0=(18.1, 0.154, -0.758), xc=(0.497, -0.00865, 0.731),
                    beta=(4.35, 0.0393, 0.415), Delta=200),
    "500_AGN": dict(P0=(7.49, 0.226, -0.957), xc=(0.71, -0.0833, 0.853),
                    beta=(4.19, 0.048, 0.615), Delta=500),
    "500_SH": dict(P0=(20.7, -0.074, -0.743), xc=(0.428, 0.011, 1.01),
                   beta=(3.82, 0.0375, 0.535), Delta=500),
}

_DENSITY_CAL = {
    "200_AGN": dict(rho0=(4e3, 0.29, -0.66), alpha=(0.88, -0.03, 0.19),
                    beta=(3.83, 0.04, -0.025)),
    "200_SH": dict(rho0=(1.9e4, 0.09, -0.95), alpha=(0.7, -0.017, 0.27),
                   beta=(4.43, 0.005, 0.037)),
}


def _plaw(cal, M14, z):
    A, mu, nu = cal
    return A * M14 ** mu * (1 + z) ** nu


def _truncated(prof, x, truncate):
    if truncate:
        prof = torch.where(x > truncate, torch.zeros_like(prof), prof)
    return prof


class Pressure(Profile):
    """GNFW pressure with Battaglia12 calibrations (reference
    Battaglia.py:12-172). Output: CGS (erg/cm^3)."""

    model_param_names = []
    per_halo_r = True

    def __init__(self, Model_def, mass_def=_massdef.MassDef200c,
                 truncate=False, **kwargs):
        if Model_def not in _PRESSURE_CAL:
            raise ValueError("Model_def must be one of "
                             f"{list(_PRESSURE_CAL)}")
        self.Model_def = Model_def
        self.mdef = _massdef.MassDef(_PRESSURE_CAL[Model_def]["Delta"],
                                     "critical")
        self.truncate = truncate
        super().__init__(mass_def=mass_def, **kwargs)
        self.update_precision_fftlog(plaw_fourier=-2,
                                     padding_lo_fftlog=1e-4,
                                     padding_hi_fftlog=1e4)

    def _real(self, cosmo, r_use, M_use, a):
        z = 1 / a - 1
        cal = _PRESSURE_CAL[self.Model_def]
        M14 = M_use / 1e14
        P_0 = _plaw(cal["P0"], M14, z)[:, None]
        x_c = _plaw(cal["xc"], M14, z)[:, None]
        beta = _plaw(cal["beta"], M14, z)[:, None]

        R = (self.mdef.get_radius(cosmo, M_use, a) / a).to(M_use.device)
        x = _rows(r_use) / R[:, None]

        Delta = self.mdef.Delta
        fb = cosmo.Omega_b / cosmo.Omega_m
        rho_crit_com = _core.rho_crit(cosmo, a) * a ** 3    # comoving
        P_delta = (Delta * rho_crit_com * fb * const.G * M_use
                   / (2 * R * a))[:, None]

        alpha, gamma = 1.0, -0.3
        prof = P_delta * P_0 * (x / x_c) ** gamma \
            * (1 + (x / x_c) ** alpha) ** (-beta)
        # Msun / Mpc / s^2 -> CGS erg/cm^3
        prof = prof * const.Msun_to_g / const.Mpc_to_cm
        return _truncated(prof, x, self.truncate)


class ElectronPressure(Pressure):
    """P_e = Pth_to_Pe * P (reference Battaglia.py:175-207)."""

    def _real(self, cosmo, r_use, M_use, a):
        return const.Pth_to_Pe * super()._real(cosmo, r_use, M_use, a)


class GasDensity(Profile):
    """GNFW gas density with Battaglia12 calibrations (reference
    Battaglia.py:210-310). Output: comoving Msun/Mpc^3."""

    model_param_names = []
    per_halo_r = True

    def __init__(self, Model_def, truncate=False, **kwargs):
        if Model_def not in _DENSITY_CAL:
            raise ValueError(f"Model_def must be one of {list(_DENSITY_CAL)}")
        self.Model_def = Model_def
        self.mdef = _massdef.MassDef(200, "critical")
        self.truncate = truncate
        super().__init__(mass_def=self.mdef, **kwargs)
        self.update_precision_fftlog(plaw_fourier=-2,
                                     padding_lo_fftlog=1e-4,
                                     padding_hi_fftlog=1e4)

    def _real(self, cosmo, r_use, M_use, a):
        z = 1 / a - 1
        cal = _DENSITY_CAL[self.Model_def]
        M14 = M_use / 1e14
        rho_0 = _plaw(cal["rho0"], M14, z)[:, None]
        alpha = _plaw(cal["alpha"], M14, z)[:, None]
        beta = _plaw(cal["beta"], M14, z)[:, None]
        x_c, gamma = 0.5, -0.2

        R = (self.mdef.get_radius(cosmo, M_use, a) / a).to(M_use.device)
        x = _rows(r_use) / R[:, None]
        fb = cosmo.Omega_b / cosmo.Omega_m
        rho_crit_com = _core.rho_crit(cosmo, a) * a ** 3
        prof = rho_crit_com * fb * rho_0 * (x / x_c) ** gamma \
            * (1 + (x / x_c) ** alpha) ** (-((beta + gamma) / alpha))
        return _truncated(prof, x, self.truncate)
