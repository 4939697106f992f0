"""Thermodynamic profiles on Schneider19-parameterized components (port of
``baryonforge_tpu.Profiles.Thermodynamic``), plain torch in float64.

Hydrostatic-equilibrium pressure by inward cumulative integration of
dP/dr = -G M(<r) rho_gas / r^2 (flip, integrate, flip), the tSZ Compton-y
prefactors, temperature, non-thermal fractions and gas number density.
``model_params`` is the union of the Schneider19, Arico20 and Mead20
parameter lists; the port keeps its own copy of the two families it has
not ported yet.
"""

import math

import torch

from .Base import Profile, hyper_params, sigmoid_cutoff
from .Schneider19 import Gas, DarkMatterBaryon, TwoHalo, _halo_radius
from .Schneider19 import model_params as S19_mp
from ..cosmo import massdef as _massdef
from ..cosmo import power as _power
from ..cosmo import concentration as _conc
from ..ops.grids import jnp_geomspace
from ..ops.integrate import cumulative_simpson_uniform, cumulative_trapezoid
from ..ops.interp import pchip_derivatives, pchip_eval
from ..utils import constants as const
from ..utils.Tabulate import _set_parameter

__all__ = ['Pressure', 'NonThermalFrac', 'NonThermalFracGreen20',
           'Temperature', 'ThermalSZ', 'ElectronPressure',
           'GasNumberDensity', 'XrayLuminosity']

# the parameter lists of baryonforge_tpu/Profiles/Arico20.py:43-53 and
# Mead20.py:37-41
A20_mp = ['cdelta', 'a', 'n', 'q', 'p', 'cutoff', 'proj_cutoff',
          'theta_out', 'theta_inn', 'M_inn', 'M_c', 'mu', 'beta',
          'M_r', 'beta_r', 'eta', 'theta_rg', 'sigma_rg', 'epsilon_hydro',
          'M1_0', 'alpha_g', 'epsilon_h',
          'M1_fsat', 'eps_fsat', 'alpha_fsat', 'delta_fsat', 'gamma_fsat',
          'A_nt', 'alpha_nt', 'mean_molecular_weight']
M20_mp = ['cdelta', 'eps1', 'nu_eps1', 'eps2', 'cutoff', 'proj_cutoff',
          'p', 'q', 'M_0', 'beta', 'Gamma', 'nu_Gamma', 'eta_b',
          'A_star', 'nu_A_star', 'M_star', 'nu_M_star', 'sigma_star',
          'epsilon_h', 'eta', 'T_w', 'nu_T_w',
          'mean_molecular_weight', 'alpha']

model_params = list({*S19_mp, *A20_mp, *M20_mp})
Pressure_at_infinity = 1e-200


def _atleast_2d(x):
    return x if x.dim() >= 2 else x.reshape(1, -1)


class BaseThermodynamicProfile(Profile):
    """Delegates parameter views to the ``prof4params`` member
    (reference Thermodynamic.py:25-67)."""

    model_param_names = model_params
    hyper_param_names = hyper_params

    @property
    def model_params(self):
        src = getattr(self, "prof4params", self)
        return {k: v for k, v in vars(src).items()
                if k in self.model_param_names}

    @property
    def hyper_params(self):
        src = getattr(self, "prof4params", self)
        params = {k: v for k, v in vars(src).items()
                  if k in self.hyper_param_names}
        params["c_M_relation"] = self._c_M_relation
        params["use_fftlog_projection"] = self._use_fftlog_projection
        return params


class Pressure(BaseThermodynamicProfile):
    """Hydrostatic-equilibrium pressure: cumulative mass by Simpson, inward
    trapezoid integration from r = infinity, PCHIP resampling in ln P, CGS
    conversion and 1/a (reference Thermodynamic.py:70-266). The default
    DMB is the one-halo DarkMatterBaryon - TwoHalo, so its TwoHalo term
    runs the FFTLog transform (kernel K8 on CUDA)."""

    def __init__(self, gas=None, darkmatterbaryon=None, **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        if darkmatterbaryon is None:
            darkmatterbaryon = DarkMatterBaryon(**kwargs) - TwoHalo(**kwargs)
        self.DarkMatterBaryon = darkmatterbaryon
        _set_parameter(self.Gas, "cutoff", 1000)
        _set_parameter(self.DarkMatterBaryon, "cutoff", 1000)
        self.prof4params = self.Gas
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        r_int = torch.as_tensor(jnp_geomspace(self.r_min_int, self.r_max_int,
                                              self.r_steps),
                                device=M_use.device)
        lnr = torch.log(r_int)
        dlnr = lnr[1] - lnr[0]

        rho_total = _atleast_2d(
            self.DarkMatterBaryon._real(cosmo, r_int, M_use, a))
        rho_gas = _atleast_2d(self.Gas._real(cosmo, r_int, M_use, a))

        dV = 4 * math.pi * r_int ** 3 * dlnr
        M_total = cumulative_simpson_uniform(dV * rho_total, dx=1.0) \
            + dV[0] * rho_total[:, :1]
        dP_dr = -const.G * M_total * rho_gas / r_int ** 2

        # inward integration from infinity: flip, cumulative trapezoid, flip
        intgr = torch.flip(dP_dr * r_int, [-1]) * dlnr
        P = -(torch.flip(cumulative_trapezoid(intgr), [-1]) + intgr[:, :1])
        # P rows decrease outward; resample ln P with PCHIP
        lnP = torch.log(P + Pressure_at_infinity)
        d = pchip_derivatives(lnr, lnP)
        ln_ru = torch.log(r_use)
        out = torch.exp(pchip_eval(lnr, lnP, d, ln_ru)) - Pressure_at_infinity
        inside = (ln_ru >= lnr[0]) & (ln_ru <= lnr[-1])
        out = torch.where(inside[None, :], out, torch.zeros_like(out))
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
        out = out * const.Msun_to_g / const.Mpc_to_cm   # -> erg/cm^3
        out = out / a
        return out * sigmoid_cutoff(r_use[None, :], self.cutoff)


class NonThermalFrac(BaseThermodynamicProfile):
    """Pandey25 eq. 15/16: f_nt = alpha_nt f_z (r/R)^gamma_nt with
    f_z = min[(1+z)^nu, (f_max - 1) tanh(nu z) + 1]
    (reference Thermodynamic.py:270-355)."""

    def __init__(self, alpha_nt=None, nu_nt=None, gamma_nt=None, **kwargs):
        super().__init__(**kwargs)
        if alpha_nt is not None:
            self.alpha_nt = alpha_nt
        if nu_nt is not None:
            self.nu_nt = nu_nt
        if gamma_nt is not None:
            self.gamma_nt = gamma_nt

    def _real(self, cosmo, r_use, M_use, a):
        z = 1 / a - 1
        R = _halo_radius(self, cosmo, M_use, a)
        f_max = 6.0 ** (-self.gamma_nt) / self.alpha_nt
        f_z = min((1 + z) ** self.nu_nt,
                  (f_max - 1) * math.tanh(self.nu_nt * z) + 1)
        f_nt = self.alpha_nt * f_z \
            * (r_use[None, :] / R[:, None]) ** self.gamma_nt
        return torch.clamp(f_nt, 0.0, 1.0)


class NonThermalFracGreen20(BaseThermodynamicProfile):
    """Parameter-free Green20 form on R200m
    (reference Thermodynamic.py:359-417)."""

    def _real(self, cosmo, r_use, M_use, a):
        conc = _conc.ConcentrationDiemer15(mass_def=self.mass_def)
        c_in = conc(cosmo, M_use, a)
        M200m, _ = _massdef.translate_mass(cosmo, M_use, a, c_in,
                                           self.mass_def,
                                           _massdef.MassDef200m)
        R200m = (_massdef.MassDef200m.get_radius(cosmo, M200m, a) / a).to(
            M_use.device)
        x = r_use[None, :] / R200m[:, None]
        nu_M = (1.686 / _power.sigmaM(cosmo, M200m, a))[:, None]
        A, b, c, d, e, f = 0.495, 0.719, 1.417, -0.166, 0.265, -2.116
        nth = 1 - A * (1 + torch.exp(-(x / b) ** c)) \
            * (nu_M / 4.1) ** (d / (1 + (x / e) ** f))
        return torch.clamp(nth, 0.0, 1.0)


class ElectronPressure(Pressure):
    """P_e = Pth_to_Pe x P (reference Thermodynamic.py:421-447)."""

    def _real(self, cosmo, r_use, M_use, a):
        return const.Pth_to_Pe * super()._real(cosmo, r_use, M_use, a)


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

    def __init__(self, pressure=None, gasnumberdensity=None, **kwargs):
        if pressure is None:
            pressure = Pressure(**kwargs) * (1 - NonThermalFrac(**kwargs))
        self.Pressure = pressure
        self.GasNumberDensity = (gasnumberdensity
                                 if gasnumberdensity is not None
                                 else GasNumberDensity(**kwargs))
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


class ThermalSZ(BaseThermodynamicProfile):
    """Compton-y: sigma_T/(m_e c^2) * Mpc_to_cm * Pgas_to_Pe * P;
    ``projected`` gives y (reference Thermodynamic.py:653-751)."""

    def __init__(self, pressure=None, **kwargs):
        self.Pressure = (pressure if pressure is not None
                         else Pressure(**kwargs))
        super().__init__(**kwargs)
        self.prof4params = getattr(self.Pressure, "prof4params", self)

    def Pgas_to_Pe(self, cosmo, r, M, a):
        return const.Pth_to_Pe

    def _real(self, cosmo, r_use, M_use, a):
        prof = _atleast_2d(self.Pressure._real(cosmo, r_use, M_use, a))
        prof = prof * const.Mpc_to_cm
        prof = prof * const.SIGMA_T_CGS / (const.M_ELECTRON_CGS
                                           * const.C_CGS ** 2)
        return prof * self.Pgas_to_Pe(cosmo, r_use, M_use, a)


class XrayLuminosity(BaseThermodynamicProfile):
    """n^2 T: unfinished in the reference (its constructor raises;
    Thermodynamic.py:754-797). Kept for API parity."""

    def __init__(self, temperature=None, gasnumberdensity=None, **kwargs):
        raise NotImplementedError(
            "XrayLuminosity is unfinished in the reference (missing "
            "cooling-factor calibrations) and is kept only for API parity")
