"""Mead et al. 2020 (HMx) model family (port of
``baryonforge_tpu.Profiles.Mead20``), plain torch in float64.

Distinctives: a Gaussian stellar fraction in log10 M, the bound fraction
f_bnd = f_bar (M/M0)^beta / (1 + (M/M0)^beta), and the concentration
modification c -> c (1 + eps1 + (eps2 - eps1) f_bnd / f_bar). Ships the six
HMx T_AGN calibrations and ``Tagn2pars`` (numpy), calibration data as the
reference gives it (Mead20.py:1118-1218).
"""

import math
import warnings

import numpy as np
import torch

from .Base import (Profile, hyper_params, sigmoid_cutoff, _host, _rows,
                   _halo_radius, _per_halo_loggrid)
from . import Schneider19 as S19
from .misc import Zeros
from ..cosmo import massdef as _massdef
from ..cosmo import concentration as _conc
from ..ops.grids import jnp_geomspace
from ..ops.integrate import trapz
from ..utils import constants as const
from ..utils.misc import safe_Pchip_minimize

__all__ = ['model_params', 'MeadProfiles', 'DarkMatter', 'TwoHalo',
           'CentralStars', 'SatelliteStars', 'Stars', 'DeltaStars',
           'BoundGas', 'EjectedGas', 'Gas', 'GasAddDiffuse',
           'CollisionlessMatter', 'DarkMatterOnly', 'DarkMatterBaryon',
           'DarkMatterBaryonAddDiffuse', 'DarkMatterOnlywithLSS',
           'DarkMatterBaryonwithLSS', 'Temperature', 'Pressure',
           'PressureAddDiffuse', 'Tagn2pars',
           'Params_TAGN_7p6_All', 'Params_TAGN_7p8_All',
           'Params_TAGN_8p0_All', 'Params_TAGN_7p6_MPr',
           'Params_TAGN_7p8_MPr', 'Params_TAGN_8p0_MPr']

model_params = ['cdelta', 'eps1', 'nu_eps1', 'eps2', 'cutoff', 'proj_cutoff',
                'p', 'q', 'M_0', 'beta', 'Gamma', 'nu_Gamma', 'eta_b',
                'A_star', 'nu_A_star', 'M_star', 'nu_M_star', 'sigma_star',
                'epsilon_h', 'eta', 'T_w', 'nu_T_w',
                'mean_molecular_weight', 'alpha']


def _f_bar(cosmo):
    return cosmo.Omega_b / cosmo.Omega_m


def _n_cgs(rho, mu):
    """Number density [1/cm^3] of a gas of density rho [Msun/Mpc^3]."""
    return rho * const.Msun_to_g / const.Mpc_to_cm ** 3 \
        / (mu * const.M_PROTON_CGS)


class MeadProfiles(Profile):
    """Family base: the HMx fractions and the concentration modification
    (reference Mead20.py:44-159)."""

    model_param_names = model_params
    hyper_param_names = hyper_params

    def _get_star_frac(self, M_use, a, cosmo):
        z = 1 / a - 1
        Astr = self.A_star + self.nu_A_star * z
        Mstr = self.M_star * math.exp(z * self.nu_M_star)
        f_str = Astr * torch.exp(
            -(torch.log10(M_use / Mstr) / self.sigma_star) ** 2 / 2)
        f_str = torch.where(M_use > Mstr, torch.clamp(f_str, min=Astr / 3),
                            f_str)
        fb = _f_bar(cosmo)
        f_bnd = fb * (M_use / self.M_0) ** self.beta \
            / (1 + (M_use / self.M_0) ** self.beta)
        f_sum = f_bnd + f_str
        f_str = torch.where(f_sum > fb, f_str - (f_sum - fb), f_str)
        f_str = torch.clamp(f_str, min=1e-10)
        below = M_use < Mstr
        f_cen = f_str * torch.clamp(torch.where(
            below, torch.ones_like(M_use), (M_use / Mstr) ** self.eta), 0, 1)
        f_sat = f_str * torch.clamp(torch.where(
            below, torch.zeros_like(M_use), 1 - (M_use / Mstr) ** self.eta),
            0, 1)
        return f_str, f_cen, f_sat

    def get_f_star(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo)[0]

    def get_f_star_cen(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo)[1]

    def get_f_star_sat(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo)[2]

    def _get_gas_frac(self, M_use, a, cosmo):
        f_str = self.get_f_star(M_use, a, cosmo)
        fb = _f_bar(cosmo)
        f_bnd = fb * (M_use / self.M_0) ** self.beta \
            / (1 + (M_use / self.M_0) ** self.beta)
        f_ej = fb - f_str - f_bnd
        return f_bnd, f_ej

    def get_f_gas(self, M_use, a, cosmo):
        f = self._get_gas_frac(M_use, a, cosmo)
        return f[0] + f[1]

    def _modify_concentration(self, cosmo, c, M, a):
        z = 1 / a - 1
        fb = _f_bar(cosmo)
        f_bnd = self._get_gas_frac(M, a, cosmo)[0]
        eps1 = self.eps1 + z * self.nu_eps1
        return c * (1 + eps1 + (self.eps2 - eps1) * f_bnd / fb)

    def _get_concentration(self, cosmo, M_use, a):
        """Duffy08 by default, not Diemer15 (reference Mead20.py:436-438)."""
        cdelta = getattr(self, "cdelta", None)
        if (cdelta is None) and (self.c_M_relation is None):
            rel = _conc.ConcentrationDuffy08(mass_def=self.mass_def)
        elif self.c_M_relation is not None:
            rel = self.c_M_relation
        else:
            rel = _conc.ConcentrationConstant(c=cdelta,
                                              mass_def=self.mass_def)
        c = rel(cosmo, M_use, a).to(M_use.device)
        return torch.where(torch.isfinite(c), c, torch.ones_like(c))

    def _modified_concentration(self, cosmo, M_use, a):
        c = self._get_concentration(cosmo, M_use, a)
        return self._modify_concentration(cosmo, c, M_use, a)


class DarkMatter(MeadProfiles):
    """NFW truncated at R, analytic norm, the concentration unmodified
    (reference Mead20.py:162-234)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        c = self._get_concentration(cosmo, M_use, a)
        R = _halo_radius(self, cosmo, M_use, a)
        r_s = R / c
        rho_c = (M_use / (4 * math.pi * r_s ** 3
                          * _massdef.nfw_mu(c)))[:, None]
        r_s = r_s[:, None]
        kfac = sigmoid_cutoff(rr, self.cutoff)
        prof = rho_c / (rr / r_s * (1 + rr / r_s) ** 2) * kfac
        return torch.where(rr <= R[:, None], prof, torch.zeros_like(prof))


class TwoHalo(S19.TwoHalo, MeadProfiles):
    """= the Schneider19 TwoHalo (reference Mead20.py:237-238)."""
    model_param_names = model_params


class CentralStars(MeadProfiles):
    """S19-style exponential with f_cen (reference Mead20.py:241-296)."""

    per_halo_r = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.update_precision_fftlog(padding_lo_fftlog=1e-5,
                                     padding_hi_fftlog=1e5)

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        R = _halo_radius(self, cosmo, M_use, a)
        f_cen = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        R_h = self.epsilon_h * R[:, None]
        return (f_cen * M_use[:, None] / (4 * math.pi ** 1.5 * R_h)
                / rr ** 2 * torch.exp(-(rr / 2 / R_h) ** 2))


class SatelliteStars(DarkMatter):
    """NFW rescaled by f_sat (reference Mead20.py:299-317)."""

    def _real(self, cosmo, r_use, M_use, a):
        f_sat = self.get_f_star_sat(M_use, a, cosmo)[:, None]
        return super()._real(cosmo, r_use, M_use, a) * f_sat


class Stars(MeadProfiles):
    """CentralStars + SatelliteStars (reference Mead20.py:320)."""

    per_halo_r = True

    def __init__(self, **kwargs):
        self.myprof = CentralStars(**kwargs) + SatelliteStars(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return self.myprof._real(cosmo, r_use, M_use, a)


class DeltaStars(MeadProfiles):
    """Mead's delta-function stars: constant in Fourier space (reference
    Mead20.py:342-396)."""

    per_halo_r = True

    def _fourier(self, cosmo, k_use, M_use, a):
        f_cen = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        return f_cen * M_use[:, None] * torch.ones_like(k_use)[None, :]

    def _real(self, cosmo, r_use, M_use, a):
        # the inverse transform of a constant is a delta function: a narrow
        # Gaussian stands for it
        f_cen = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        sig = 1e-3
        gauss = torch.exp(-_rows(r_use) ** 2 / (2 * sig ** 2)) \
            / (2 * math.pi * sig ** 2) ** 1.5
        return f_cen * M_use[:, None] * gauss


class BoundGas(MeadProfiles):
    """Komatsu-Seljak-like [ln(1+x)/x]^(1/(Gamma-1)) truncated at R,
    normalised a halo, the concentration modified (reference
    Mead20.py:398-485)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        z = 1 / a - 1
        c = self._modified_concentration(cosmo, M_use, a)
        R = _halo_radius(self, cosmo, M_use, a)
        r_s = (R / c)[:, None]
        Geff = self.Gamma + self.nu_Gamma * z
        if isinstance(Geff, float) and Geff - 1 < 0.01:
            warnings.warn(f"Gamma = {Geff:0.4f} too close to 1")
        f_bnd = self._get_gas_frac(M_use, a, cosmo)[0][:, None]

        r_int = _per_halo_loggrid(self.r_min_int, R, self.r_steps)
        x_i = r_int / r_s
        shape_i = (torch.log(1 + x_i) / x_i) ** (1 / (Geff - 1))
        norm = trapz(4 * math.pi * r_int ** 2 * shape_i, r_int)[:, None]

        kfac = sigmoid_cutoff(rr, self.cutoff)
        x = rr / r_s
        prof = (torch.log(1 + x) / x) ** (1 / (Geff - 1))
        prof = torch.where(rr <= R[:, None], prof, torch.zeros_like(prof))
        return prof * f_bnd * M_use[:, None] / norm * kfac


class EjectedGas(MeadProfiles):
    """Gaussian ejected gas, R_ej from the Maxwellian escape condition, one
    root a halo (reference Mead20.py:488-558)."""

    per_halo_r = True

    def _r_ej(self, cosmo, M_use, a):
        R = _halo_radius(self, cosmo, M_use, a)
        fb = _f_bar(cosmo)
        f_ej = self._get_gas_frac(M_use, a, cosmo)[1][:, None]
        R_esc = 0.5 * math.sqrt(200.0) * R[:, None]
        rgrid = torch.as_tensor(jnp_geomspace(self.r_min_int, self.r_max_int,
                                              self.r_steps),
                                device=M_use.device)
        arg = self.eta_b * R_esc / rgrid[None, :]
        term1 = 1 - torch.special.erf(arg / math.sqrt(2.0))
        term2 = math.sqrt(2 / math.pi) * arg * torch.exp(-arg ** 2 / 2)
        diff = term1 + term2 - f_ej / fb
        ln_Rej = safe_Pchip_minimize(diff, torch.log(rgrid))
        R_ej = torch.exp(ln_Rej)[:, None]
        return torch.where(f_ej > 0, R_ej, torch.full_like(R_ej, math.inf)), \
            f_ej

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        R_ej, f_ej = self._r_ej(cosmo, M_use, a)
        kfac = sigmoid_cutoff(rr, self.cutoff)
        return (f_ej * M_use[:, None] / (2 * math.pi * R_ej ** 2) ** 1.5
                * torch.exp(-(rr / R_ej) ** 2 / 2) * kfac)


class Gas(MeadProfiles):
    """BoundGas + EjectedGas (reference Mead20.py:561-616)."""

    per_halo_r = True

    def __init__(self, **kwargs):
        self.myprof = BoundGas(**kwargs) + EjectedGas(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return self.myprof._real(cosmo, r_use, M_use, a)


class GasAddDiffuse(MeadProfiles):
    """Bound gas, and the ejected gas as a constant in Fourier space:
    fourier = BG.fourier + f_ej M (reference Mead20.py:561-616)."""

    per_halo_r = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.BG = BoundGas(**kwargs)

    def _fourier(self, cosmo, k_use, M_use, a):
        f_ej = self._get_gas_frac(M_use, a, cosmo)[1][:, None]
        return (torch.atleast_2d(self.BG.fourier(cosmo, k_use, M_use, a))
                + f_ej * M_use[:, None])

    def _real(self, cosmo, r_use, M_use, a):
        # a uniform diffuse background is no one-halo profile: the real-space
        # view is the bound part
        return self.BG._real(cosmo, r_use, M_use, a)


class CollisionlessMatter(MeadProfiles):
    """NFW with the modified concentration rescaled by (1 - f_bar); HMx has
    no relaxation (reference Mead20.py:618-699)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        c = self._modified_concentration(cosmo, M_use, a)
        R = _halo_radius(self, cosmo, M_use, a)
        r_s = R / c
        rho_c = M_use / (4 * math.pi * r_s ** 3 * _massdef.nfw_mu(c))
        rho_c = (rho_c * (1 - _f_bar(cosmo)))[:, None]
        r_s = r_s[:, None]
        kfac = sigmoid_cutoff(rr, self.cutoff)
        prof = rho_c / (rr / r_s * (1 + rr / r_s) ** 2) * kfac
        return torch.where(rr <= R[:, None], prof, torch.zeros_like(prof))


class DarkMatterOnly(DarkMatter):
    """= DarkMatter (reference Mead20.py:702)."""


class DarkMatterBaryon(MeadProfiles):
    """CLM + Stars + Gas, with TwoHalo = Zeros (reference Mead20.py:705)."""

    def __init__(self, gas=None, stars=None, collisionlessmatter=None,
                 darkmatter=None, **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.TwoHalo = Zeros()
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.CollisionlessMatter = (collisionlessmatter
                                    if collisionlessmatter is not None
                                    else CollisionlessMatter(**kwargs))
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return (self.CollisionlessMatter._real(cosmo, r_use, M_use, a)
                + self.Stars._real(cosmo, r_use, M_use, a)
                + self.Gas._real(cosmo, r_use, M_use, a))


class DarkMatterBaryonAddDiffuse(DarkMatterBaryon):
    """The Fourier-space composite with the diffuse ejected-gas constant
    (reference Mead20.py:760-871)."""

    def __init__(self, gas=None, **kwargs):
        gas = gas if gas is not None else GasAddDiffuse(**kwargs)
        super().__init__(gas=gas, **kwargs)

    def _fourier(self, cosmo, k_use, M_use, a):
        return (torch.atleast_2d(self.CollisionlessMatter.fourier(
                    cosmo, k_use, M_use, a))
                + torch.atleast_2d(self.Stars.myprof.fourier(
                    cosmo, k_use, M_use, a))
                + torch.atleast_2d(self.Gas._fourier(cosmo, k_use, M_use,
                                                     a)))


class DarkMatterOnlywithLSS(MeadProfiles):
    """DarkMatter + TwoHalo."""

    def __init__(self, darkmatter=None, twohalo=None, **kwargs):
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return (self.DarkMatter._real(cosmo, r_use, M_use, a)
                + self.TwoHalo._real(cosmo, r_use, M_use, a))


class DarkMatterBaryonwithLSS(DarkMatterBaryon):
    """DMB + TwoHalo."""

    def __init__(self, twohalo=None, **kwargs):
        super().__init__(**kwargs)
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return (super()._real(cosmo, r_use, M_use, a)
                + self.TwoHalo._real(cosmo, r_use, M_use, a))


class Temperature(MeadProfiles):
    """T0 ln(1+x)/x with T0 = alpha E0 / (3/2 k_B), E0 = G M mu m_p / (a R)
    (reference Mead20.py:874-946)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        c = self._modified_concentration(cosmo, M_use, a)
        R = _halo_radius(self, cosmo, M_use, a)
        r_s = (R / c)[:, None]
        # E0 [erg] = G M mu m_p / (a R): G M / R in Mpc^2/s^2 -> cm^2/s^2,
        # times mu m_p [g]
        E0 = (const.G * M_use / (a * R)) * const.Mpc_to_cm ** 2 \
            * (const.M_PROTON_CGS * self.mean_molecular_weight)
        T0 = self.alpha * E0 / (1.5 * const.K_BOLTZ_CGS)
        x = _rows(r_use) / r_s
        return T0[:, None] * torch.log(1 + x) / x

    def projected(self, cosmo, r, M, a, **kw):
        # averaged along the line of sight: divided by 2 r_max (reference
        # Mead20.py:940-946)
        r_max = self.padding_hi_proj * float(np.max(_host(r)))
        if self.proj_cutoff is not None:
            r_max = self.proj_cutoff
        return super().projected(cosmo, r, M, a, **kw) / (2 * r_max)


class Pressure(MeadProfiles):
    """P = n_bnd T_bnd k_B + n_ej T_w e^(nu_Tw z) k_B (reference
    Mead20.py:950-1026)."""

    per_halo_r = True

    def __init__(self, boundgas=None, ejectedgas=None, temperature=None,
                 **kwargs):
        self.BoundGas = (boundgas if boundgas is not None
                         else BoundGas(**kwargs))
        self.EjectedGas = (ejectedgas if ejectedgas is not None
                           else EjectedGas(**kwargs))
        self.Temperature = (temperature if temperature is not None
                            else Temperature(**kwargs))
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        z = 1 / a - 1
        mu = self.mean_molecular_weight
        T = self.Temperature._real(cosmo, r_use, M_use, a)
        n = _n_cgs(self.BoundGas._real(cosmo, r_use, M_use, a), mu)
        P1 = T * n * const.K_BOLTZ_CGS
        T_w = self.T_w * math.exp(self.nu_T_w * z)
        n2 = _n_cgs(self.EjectedGas._real(cosmo, r_use, M_use, a), mu)
        return P1 + T_w * n2 * const.K_BOLTZ_CGS


class PressureAddDiffuse(MeadProfiles):
    """Fourier-space pressure with the diffuse ejected term (reference
    Mead20.py:1029-1115)."""

    per_halo_r = True

    def __init__(self, pressure=None, **kwargs):
        self.Pressure = (pressure if pressure is not None
                         else Pressure(**kwargs, ejectedgas=Zeros()))
        if not isinstance(self.Pressure.EjectedGas, Zeros):
            warnings.warn("PressureAddDiffuse expects ejectedgas=Zeros() "
                          "to avoid double counting")
        super().__init__(**kwargs)

    def _fourier(self, cosmo, k_use, M_use, a):
        z = 1 / a - 1
        P1 = torch.atleast_2d(self.Pressure.fourier(cosmo, k_use, M_use, a))
        f_ej = self._get_gas_frac(M_use, a, cosmo)[1][:, None]
        T = self.T_w * math.exp(self.nu_T_w * z)
        n = (f_ej * M_use[:, None] * const.Msun_to_g
             / const.Mpc_to_cm ** 3
             / (self.mean_molecular_weight * const.M_PROTON_CGS))
        return P1 + T * n * const.K_BOLTZ_CGS

    def _real(self, cosmo, r_use, M_use, a):
        return self.Pressure._real(cosmo, r_use, M_use, a)


# ---------------------------------------------------------------------------
# HMx T_AGN calibrations (Msun/h -> Msun at h = 0.7), calibration data as
# the reference gives it (Mead20.py:1118-1196)
# ---------------------------------------------------------------------------
Params_TAGN_7p6_All = {'A_star': 0.0346, 'nu_A_star': -0.0092, 'M_star': 10 ** 12.5506 / 0.7, 'nu_M_star': -0.4615, 'eta': -0.497, 'eps1': 0.4021, 'nu_eps1': 0.0435, 'Gamma': 1.2763, 'nu_Gamma': -0.0554, 'M_0': 10 ** 13.0978 / 0.7, 'T_w': 10 ** 6.6762, 'nu_T_w': -0.5566, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 1}  # noqa: E501
Params_TAGN_7p8_All = {'A_star': 0.0342, 'nu_A_star': -0.0105, 'M_star': 10 ** 12.3715 / 0.7, 'nu_M_star': 0.0149, 'eta': -0.4052, 'eps1': 0.1236, 'nu_eps1': -0.0187, 'Gamma': 1.2956, 'nu_Gamma': -0.0937, 'M_0': 10 ** 13.4854 / 0.7, 'T_w': 10 ** 6.6545, 'nu_T_w': -0.3652, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 1}  # noqa: E501
Params_TAGN_8p0_All = {'A_star': 0.0321, 'nu_A_star': -0.0094, 'M_star': 10 ** 12.3032 / 0.7, 'nu_M_star': -0.0817, 'eta': -0.3443, 'eps1': -0.1158, 'nu_eps1': 0.1408, 'Gamma': 1.2861, 'nu_Gamma': -0.1382, 'M_0': 10 ** 14.1254 / 0.7, 'T_w': 10 ** 6.6615, 'nu_T_w': -0.0617, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 1}  # noqa: E501
Params_TAGN_7p6_MPr = {'A_star': 0.0348, 'nu_A_star': -0.0093, 'M_star': 10 ** 12.462 / 0.7, 'nu_M_star': -0.3664, 'eta': -0.3428, 'eps1': -0.10017, 'nu_eps1': -0.04559, 'Gamma': 1.16468, 'nu_Gamma': 0.0, 'M_0': 10 ** 13.19486 / 0.7, 'T_w': 10 ** 6.67618, 'nu_T_w': -0.55659, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 0.7642}  # noqa: E501
Params_TAGN_7p8_MPr = {'A_star': 0.033, 'nu_A_star': -0.0088, 'M_star': 10 ** 12.4479 / 0.7, 'nu_M_star': -0.3521, 'eta': -0.3556, 'eps1': -0.1065, 'nu_eps1': -0.1073, 'Gamma': 1.17702, 'nu_Gamma': 0.0, 'M_0': 10 ** 13.59369 / 0.7, 'T_w': 10 ** 6.65445, 'nu_T_w': -0.36515, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 0.8471}  # noqa: E501
Params_TAGN_8p0_MPr = {'A_star': 0.0309, 'nu_A_star': -0.0082, 'M_star': 10 ** 12.3923 / 0.7, 'nu_M_star': -0.3073, 'eta': -0.3505, 'eps1': -0.12533, 'nu_eps1': -0.01107, 'Gamma': 1.19657, 'nu_Gamma': 0.0, 'M_0': 10 ** 14.24798 / 0.7, 'T_w': 10 ** 6.66146, 'nu_T_w': -0.06167, 'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5, 'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3, 'q': 0.707, 'alpha': 1.0314}  # noqa: E501


def Tagn2pars(Tagn, mode='All'):
    """The HMx parameters at T_AGN: linear (log-linear for M_0, M_star and
    T_w) interpolation of the three calibrations, a straight-line fit of
    them outside [7.6, 8.0] (reference Mead20.py:1199-1218)."""
    if not isinstance(Tagn, (float, int)):
        raise TypeError("T_agn must be a number")
    Tagn_calib = np.array([7.6, 7.8, 8.0])
    log_keys = ['M_0', 'M_star', 'T_w']
    if mode == 'All':
        pars = [Params_TAGN_7p6_All, Params_TAGN_7p8_All,
                Params_TAGN_8p0_All]
    elif mode == 'MatterPressure':
        pars = [Params_TAGN_7p6_MPr, Params_TAGN_7p8_MPr,
                Params_TAGN_8p0_MPr]
    else:
        raise NotImplementedError(f"mode = {mode}: use 'All' or "
                                  "'MatterPressure'")
    out = {}
    for k in pars[0]:
        vals = np.array([p[k] for p in pars], dtype=float)
        if k in log_keys:
            vals = np.log10(vals)
        if Tagn < 7.6 or Tagn > 8.0:
            v = np.polyval(np.polyfit(Tagn_calib, vals, 1), Tagn)
        else:
            v = np.interp(Tagn, Tagn_calib, vals)
        out[k] = float(10 ** v) if k in log_keys else float(v)
    return out
