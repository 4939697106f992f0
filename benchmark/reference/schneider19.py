"""Schneider et al. 2019 baryonification model family (port of
``baryonforge_tpu.Profiles.Schneider19``), plain torch in float64.

Per-halo normalisation loops of the reference become broadcast per-halo
log grids, and the adiabatic relaxation is a fixed ``max_iter``-step
fixed-point iteration over all halos at once, as in the JAX package.

A frozen copy of ``baryonforge_torch/Profiles/Schneider19.py`` at the commit that added
the benchmark: the benchmark's reference, which imports nothing of the
program and is not edited with it.
"""

import math

import torch

from .profile_base import (Profile, hyper_params, sigmoid_cutoff, _halo_radius,
                   _per_halo_loggrid)
from . import cosmo_core as _core
from . import power as _power
from .grids import jnp_geomspace
from .integrate import cumulative_simpson_uniform, trapz
from .interp import (pchip_derivatives, pchip_eval, cubic_spline_coeffs,
                          cubic_spline_eval, cubic_spline_derivative_eval)

__all__ = ["model_params", "SchneiderProfiles", "DarkMatter", "TwoHalo",
           "Stars", "SatelliteStars", "Gas", "ShockedGas",
           "CollisionlessMatter", "DarkMatterOnly", "DarkMatterBaryon"]

# parameter inventory of the reference (Schneider19.py:16-33)
model_params = ['cdelta', 'epsilon', 'a', 'n',
                'q', 'p',
                'cutoff', 'proj_cutoff',

                'theta_ej', 'theta_co', 'M_c', 'gamma', 'delta',
                'mu_theta_ej', 'mu_theta_co', 'mu_beta', 'mu_gamma', 'mu_delta',
                'M_theta_ej', 'M_theta_co', 'M_gamma', 'M_delta',
                'nu_theta_ej', 'nu_theta_co', 'nu_M_c', 'nu_gamma', 'nu_delta',
                'zeta_theta_ej', 'zeta_theta_co', 'zeta_M_c', 'zeta_gamma',
                'zeta_delta',

                'A', 'M1', 'eta', 'eta_delta', 'tau', 'tau_delta', 'epsilon_h',
                'mu_epsilon_h',
                'M_epsilon_h',
                'nu_A', 'nu_M1', 'nu_eta', 'nu_eta_delta', 'nu_tau',
                'nu_tau_delta', 'nu_epsilon_h',
                'zeta_A', 'zeta_M1', 'zeta_eta', 'zeta_eta_delta', 'zeta_tau',
                'zeta_tau_delta', 'zeta_epsilon_h',

                'alpha_nt', 'nu_nt', 'gamma_nt', 'mean_molecular_weight']


def _f_bar(cosmo):
    return cosmo.Omega_b / cosmo.Omega_m


def _grid(values, like):
    return torch.as_tensor(values, device=like.device)


class SchneiderProfiles(Profile):
    """Family base: gas parameter scalings and stellar / gas mass fractions
    (reference Schneider19.py:35-210)."""

    model_param_names = model_params
    hyper_param_names = hyper_params

    def _get_gas_params(self, M, z):
        cdelta = 1 if self.cdelta is None else self.cdelta
        M_c = self.M_c * (1 + z) ** self.nu_M_c * cdelta ** self.zeta_M_c
        beta = 3 * (M / M_c) ** self.mu_beta / (1 + (M / M_c) ** self.mu_beta)

        theta_ej = (self.theta_ej * (M / self.M_theta_ej) ** self.mu_theta_ej
                    * (1 + z) ** self.nu_theta_ej
                    * cdelta ** self.zeta_theta_ej)
        theta_co = (self.theta_co * (M / self.M_theta_co) ** self.mu_theta_co
                    * (1 + z) ** self.nu_theta_co
                    * cdelta ** self.zeta_theta_co)
        delta = (self.delta * (M / self.M_delta) ** self.mu_delta
                 * (1 + z) ** self.nu_delta * cdelta ** self.zeta_delta)
        gamma = (self.gamma * (M / self.M_gamma) ** self.mu_gamma
                 * (1 + z) ** self.nu_gamma * cdelta ** self.zeta_gamma)

        return (beta[:, None], theta_ej[:, None], theta_co[:, None],
                delta[:, None], gamma[:, None])

    def _get_star_frac(self, M_use, a, cosmo):
        cdelta = 1 if self.cdelta is None else self.cdelta
        z = 1 / a - 1
        A = self.A * (1 + z) ** self.nu_A * cdelta ** self.zeta_A
        eta = self.eta * (1 + z) ** self.nu_eta * cdelta ** self.zeta_eta
        tau = self.tau * (1 + z) ** self.nu_tau * cdelta ** self.zeta_tau
        eta_d = (self.eta_delta * (1 + z) ** self.nu_eta_delta
                 * cdelta ** self.zeta_eta_delta)
        tau_d = (self.tau_delta * (1 + z) ** self.nu_tau_delta
                 * cdelta ** self.zeta_tau_delta)
        M1 = self.M1 * (1 + z) ** self.nu_M1 * cdelta ** self.zeta_M1

        eta_cga = eta + eta_d
        tau_cga = tau + tau_d

        fb = _f_bar(cosmo)
        f_star = 2 * A * ((M_use / M1) ** tau + (M_use / M1) ** eta) ** -1
        f_cga = 2 * A * ((M_use / M1) ** tau_cga
                         + (M_use / M1) ** eta_cga) ** -1
        f_star = torch.clamp(f_star, 1e-10, fb)
        f_cga = torch.minimum(torch.clamp(f_cga, min=1e-10), f_star)
        f_sga = torch.clamp(f_star - f_cga, min=1e-10)
        return f_star, f_cga, f_sga

    def get_f_star(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo)[0]

    def get_f_star_cen(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo)[1]

    def get_f_star_sat(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo)[2]

    def _get_gas_frac(self, M_use, a, cosmo):
        f_star = self.get_f_star(M_use, a, cosmo)
        return torch.clamp(_f_bar(cosmo) - f_star, min=1e-10)

    def get_f_gas(self, M_use, a, cosmo):
        return self._get_gas_frac(M_use, a, cosmo)


class DarkMatter(SchneiderProfiles):
    """Truncated NFW with a numeric per-halo normalisation to M(<R)
    (reference Schneider19.py:214-309)."""

    def _real(self, cosmo, r_use, M_use, a):
        c = self._get_concentration(cosmo, M_use, a)
        R = _halo_radius(self, cosmo, M_use, a)
        r_s = (R / c)[:, None]
        r_t = (R * self.epsilon)[:, None]

        r_int = _per_halo_loggrid(self.r_min_int, R, self.r_steps)
        shape = (1.0 / (r_int / r_s * (1 + r_int / r_s) ** 2)
                 * 1.0 / (1 + (r_int / r_t) ** 2) ** 2)
        norm = trapz(4 * math.pi * r_int ** 2 * shape, r_int)
        rho_c = (M_use / norm)[:, None]

        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        return (rho_c / (r_use / r_s * (1 + r_use / r_s) ** 2)
                / (1 + (r_use / r_t) ** 2) ** 2 * kfac)


class TwoHalo(SchneiderProfiles):
    """(1 + b(M) xi_mm(r)) rho_m with the Sheth-Tormen bias (reference
    Schneider19.py:312-399). xi_mm comes from ``correlation_3d`` (FFTLog,
    kernel K8 on CUDA) unless the ``xi_mm`` hook gives it."""

    def _real(self, cosmo, r_use, M_use, a):
        if self.xi_mm is None:
            xi = _power.correlation_3d(cosmo, r_use, a=a)
        else:
            xi = self.xi_mm(r_use, a)

        delta_c = 1.686 / _core.growth_factor(cosmo, a)
        nu_M = delta_c / _power.sigmaM(cosmo, M_use, a)
        bias = (1 + (self.q * nu_M ** 2 - 1) / delta_c
                + 2 * self.p / delta_c / (1 + (self.q * nu_M ** 2) ** self.p))
        rho_m = _core.rho_x(cosmo, a, species="matter", is_comoving=True)
        prof = (1 + bias[:, None] * xi[None, :]) * rho_m
        return prof * sigmoid_cutoff(r_use[None, :], self.cutoff)


class Stars(SchneiderProfiles):
    """Central-galaxy exponential stellar profile (reference
    Schneider19.py:402-500)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        # extreme padding against Fourier ringing (reference 459-466)
        self.update_precision_fftlog(padding_lo_fftlog=1e-5,
                                     padding_hi_fftlog=1e5)

    def _real(self, cosmo, r_use, M_use, a):
        z = 1 / a - 1
        R = _halo_radius(self, cosmo, M_use, a)

        cdelta = 1 if self.cdelta is None else self.cdelta
        eps_h = (self.epsilon_h * (M_use / self.M_epsilon_h)
                 ** self.mu_epsilon_h * (1 + z) ** self.nu_epsilon_h
                 * cdelta ** self.zeta_epsilon_h)
        f_cga = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        R_h = (eps_h * R)[:, None]

        M_tot = _total_dm_mass(self, cosmo, M_use, a)[:, None]

        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        return (f_cga * M_tot / (4 * math.pi ** 1.5 * R_h) / r_use ** 2
                * torch.exp(-(r_use / 2 / R_h) ** 2) * kfac)


def _total_dm_mass(prof_obj, cosmo, M_use, a):
    """∫ 4 pi r^2 rho_NFW dr on the fixed integration grid with a 1 Gpc
    cutoff, for the Stars and Gas normalisations (reference
    Schneider19.py:485-487)."""
    DM = DarkMatter(**prof_obj.model_params, **prof_obj.hyper_params)
    DM.cutoff = 1e3
    r_int = _grid(jnp_geomspace(prof_obj.r_min_int, prof_obj.r_max_int,
                                prof_obj.r_steps), M_use)
    rho = DM._real(cosmo, r_int, M_use, a)
    return trapz(4 * math.pi * r_int ** 2 * rho, r_int)


class Gas(SchneiderProfiles):
    """GNFW gas profile normalised to f_gas M_tot (reference
    Schneider19.py:503-609)."""

    def _real(self, cosmo, r_use, M_use, a):
        z = 1 / a - 1
        R = _halo_radius(self, cosmo, M_use, a)

        f_gas = self.get_f_gas(M_use, a, cosmo)[:, None]
        beta, theta_ej, theta_co, delta, gamma = self._get_gas_params(M_use, z)
        R_co = theta_co * R[:, None]
        R_ej = theta_ej * R[:, None]

        u = r_use[None, :] / R_co
        v = r_use[None, :] / R_ej

        r_int = _grid(jnp_geomspace(self.r_min_int, self.r_max_int,
                                    self.r_steps), M_use)
        u_i = r_int[None, :] / R_co
        v_i = r_int[None, :] / R_ej
        shape_i = (1 + u_i) ** -beta \
            * (1 + v_i ** gamma) ** (-(delta - beta) / gamma)
        norm = trapz(4 * math.pi * r_int ** 2 * shape_i, r_int)[:, None]

        M_tot = _total_dm_mass(self, cosmo, M_use, a)[:, None]

        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        prof = (1 + u) ** -beta * (1 + v ** gamma) ** (-(delta - beta) / gamma) \
            * kfac
        return prof * f_gas * M_tot / norm


class CollisionlessMatter(SchneiderProfiles):
    """Adiabatically relaxed collisionless component (DM + satellites).

    The reference's per-halo while-loop (Schneider19.py:876-909) is a
    fixed-point iteration of exactly ``max_iter`` steps over all halos, as
    the JAX package's fori_loop runs it (no early exit: extra steps at the
    fixed point change nothing).
    """

    def __init__(self, gas=None, stars=None, darkmatter=None, max_iter=10,
                 reltol=1e-2, r_min_int=1e-8, r_max_int=1e5, r_steps=5000,
                 **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))

        # no artificial cutoffs during relaxation (reference 812-814)
        self.Gas.set_parameter('cutoff', 1000)
        self.Stars.set_parameter('cutoff', 1000)
        self.DarkMatter.set_parameter('cutoff', 1000)

        self.max_iter = max_iter
        self.reltol = reltol
        super().__init__(**kwargs, r_min_int=r_min_int,
                         r_max_int=r_max_int, r_steps=r_steps)

    def _real(self, cosmo, r_use, M_use, a):
        r_int = _grid(jnp_geomspace(self.r_min_int, self.r_max_int,
                                    self.r_steps), M_use)
        lnr = torch.log(r_int)

        f_sga = self.get_f_star_sat(M_use, a, cosmo)[:, None]
        f_clm = 1 - _f_bar(cosmo) + f_sga

        rho_i = self.DarkMatter._real(cosmo, r_int, M_use, a)
        rho_cga = self.Stars._real(cosmo, r_int, M_use, a)
        rho_gas = self.Gas._real(cosmo, r_int, M_use, a)

        dlnr = lnr[1] - lnr[0]
        dV = 4 * math.pi * r_int ** 3 * dlnr

        def cmass(rho):
            return (cumulative_simpson_uniform(dV[None, :] * rho, dx=1.0)
                    + dV[0] * rho[:, :1])
        M_i = cmass(rho_i)
        M_cga = cmass(rho_cga)
        M_gas = cmass(rho_gas)

        # a floor of 1e-20 Msun keeps the log finite where a component
        # contributes nothing
        ln_Mi = torch.log(torch.clamp(M_i, min=1e-20))
        d_nfw = pchip_derivatives(lnr, ln_Mi)
        ln_Mc = torch.log(torch.clamp(M_cga, min=1e-20))
        d_cga = pchip_derivatives(lnr, ln_Mc)
        ln_Mg = torch.log(torch.clamp(M_gas, min=1e-20))
        d_gas = pchip_derivatives(lnr, ln_Mg)

        zeta = torch.ones_like(M_i)
        for _ in range(self.max_iter):
            ln_rf = lnr[None, :] + torch.log(zeta)
            Mcga_f = torch.exp(pchip_eval(lnr, ln_Mc, d_cga, ln_rf))
            Mgas_f = torch.exp(pchip_eval(lnr, ln_Mg, d_gas, ln_rf))
            M_f = f_clm * M_i + Mcga_f + Mgas_f
            zeta = self.a * ((M_i / M_f) ** self.n - 1) + 1

        # rho_clm from d/dr of the relaxed (shifted) NFW mass curve
        ln_M_clm = torch.log(f_clm) + pchip_eval(lnr, ln_Mi, d_nfw,
                                                  lnr - torch.log(zeta))

        d_spl = cubic_spline_coeffs(lnr, ln_M_clm)
        ln_ru = torch.log(r_use)
        log_der = cubic_spline_derivative_eval(lnr, ln_M_clm, d_spl, ln_ru)
        ln_at = cubic_spline_eval(lnr, ln_M_clm, d_spl, ln_ru)
        lin_der = log_der * torch.exp(ln_at) / r_use[None, :]
        prof = lin_der / (4 * math.pi * r_use[None, :] ** 2)
        prof = torch.clamp(prof, min=0.0)
        # outside the spline's domain: 0 (scipy extrapolate=False)
        outside = (ln_ru < lnr[0]) | (ln_ru > lnr[-1])
        prof = torch.where(outside[None, :], torch.zeros_like(prof), prof)

        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        return torch.where(torch.isfinite(prof), prof,
                           torch.zeros_like(prof)) * kfac


class DarkMatterOnly(SchneiderProfiles):
    """NFW + TwoHalo (reference Schneider19.py:958-1033)."""

    def __init__(self, darkmatter=None, twohalo=None, **kwargs):
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return (self.DarkMatter._real(cosmo, r_use, M_use, a)
                + self.TwoHalo._real(cosmo, r_use, M_use, a))


class DarkMatterBaryon(SchneiderProfiles):
    """(CLM + Stars + Gas) (M_DMO / M_DMB) + TwoHalo: the mass-conserving
    one-halo rescaling (reference Schneider19.py:1036-1160)."""

    def __init__(self, gas=None, stars=None, collisionlessmatter=None,
                 darkmatter=None, twohalo=None, r_min_int=1e-5,
                 r_max_int=100, r_steps=500, **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.CollisionlessMatter = (
            collisionlessmatter if collisionlessmatter is not None
            else CollisionlessMatter(**kwargs))
        super().__init__(**kwargs, r_min_int=r_min_int,
                         r_max_int=r_max_int, r_steps=r_steps)

    def _real(self, cosmo, r_use, M_use, a):
        r_int = _grid(jnp_geomspace(self.r_min_int, self.r_max_int,
                                    self.r_steps), M_use)

        rho_dmo = self.DarkMatter._real(cosmo, r_int, M_use, a)
        M_tot = trapz(4 * math.pi * r_int ** 2 * rho_dmo, r_int)

        clm_i = self.CollisionlessMatter._real(cosmo, r_int, M_use, a)
        str_i = self.Stars._real(cosmo, r_int, M_use, a)
        gas_i = self.Gas._real(cosmo, r_int, M_use, a)
        M_dmb = trapz(4 * math.pi * r_int ** 2 * (clm_i + str_i + gas_i),
                      r_int)

        factor = (M_tot / M_dmb)[:, None]
        return (self.CollisionlessMatter._real(cosmo, r_use, M_use, a)
                * factor
                + self.Stars._real(cosmo, r_use, M_use, a) * factor
                + self.Gas._real(cosmo, r_use, M_use, a) * factor
                + self.TwoHalo._real(cosmo, r_use, M_use, a))
