"""Thermodynamic profiles on Schneider19-parameterized components: the
hydrostatic pressure and the tSZ Compton-y.

A frozen copy of the plain (CPU) version in ``baryonforge_torch/Profiles/Thermodynamic.py`` at
the commit that added the benchmark, with the kernel wrappers left out, so
that it runs in plain PyTorch on any device. It is the benchmark's
reference: it imports nothing of the program and is not edited with it.
"""

import math

import torch

from .profile_base import Profile, hyper_params, sigmoid_cutoff
from .schneider19 import Gas, DarkMatterBaryon, TwoHalo
from .schneider19 import model_params as S19_mp
from .grids import jnp_geomspace
from .integrate import cumulative_simpson_uniform, cumulative_trapezoid
from .interp import pchip_derivatives, pchip_eval
from . import constants as const
from .tabulate import _set_parameter


# the Arico20 and Mead20 parameter lists of the program, copied
A20_mp = ['cdelta', 'a', 'n', 'q', 'p', 'cutoff', 'proj_cutoff', 'theta_out',
          'theta_inn', 'M_inn', 'M_c', 'mu', 'beta', 'M_r', 'beta_r', 'eta',
          'theta_rg', 'sigma_rg', 'epsilon_hydro', 'M1_0', 'alpha_g',
          'epsilon_h', 'M1_fsat', 'eps_fsat', 'alpha_fsat', 'delta_fsat',
          'gamma_fsat', 'A_nt', 'alpha_nt', 'mean_molecular_weight']
M20_mp = ['cdelta', 'eps1', 'nu_eps1', 'eps2', 'cutoff', 'proj_cutoff', 'p',
          'q', 'M_0', 'beta', 'Gamma', 'nu_Gamma', 'eta_b', 'A_star',
          'nu_A_star', 'M_star', 'nu_M_star', 'sigma_star', 'epsilon_h',
          'eta', 'T_w', 'nu_T_w', 'mean_molecular_weight', 'alpha']
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
