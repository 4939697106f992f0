"""Schneider et al. 2025 model family (port of
``baryonforge_tpu.Profiles.Schneider25``), plain torch in float64.

Distinctives: the nu-dependent truncation eps(nu) = eps0 + eps1 nu, the
two-halo term's exclusion factor 1 - exp(-alpha_excl r/R), gas split into
a double-slope GNFW hot gas and an inner gas r^-2 e^{-r/R} with a hard
inner cut, pure-exponential stars, and a relaxation without iteration
applied as r zeta on one shared log grid (reference Schneider25.py).
"""

import math

import torch

from .Base import (Profile, hyper_params, sigmoid_cutoff, _rows,
                   _halo_radius, _per_halo_loggrid)
from ..cosmo import core as _core
from ..cosmo import power as _power
from ..ops.grids import jnp_geomspace
from ..ops.integrate import cumulative_simpson_uniform, trapz
from ..ops.interp import (pchip_derivatives, pchip_eval, cubic_spline_coeffs,
                          cubic_spline_eval, cubic_spline_derivative_eval)

__all__ = ['model_params', 'Schneider25Profiles', 'DarkMatter', 'TwoHalo',
           'Stars', 'SatelliteStars', 'HotGas', 'InnerGas', 'Gas',
           'CollisionlessMatter', 'DarkMatterOnly', 'DarkMatterBaryon']

model_params = ['cdelta', 'epsilon0', 'epsilon1', 'alpha_excl', 'q', 'p',
                'cutoff', 'proj_cutoff',
                'q0', 'q1', 'q2', 'nu_q0', 'nu_q1', 'nu_q2', 'nstep',
                'theta_c', 'M_c', 'gamma', 'delta', 'alpha',
                'mu_theta_c', 'mu_beta', 'mu_gamma', 'mu_delta', 'mu_alpha',
                'M_theta_c', 'M_gamma', 'M_delta', 'M_alpha',
                'nu_theta_c', 'nu_M_c', 'nu_gamma', 'nu_delta', 'nu_alpha',
                'zeta_theta_c', 'zeta_M_c', 'zeta_gamma', 'zeta_delta',
                'zeta_alpha',
                'c_iga', 'nu_c_iga', 'r_min_iga',
                'Nstar', 'Mstar', 'eta', 'eta_delta', 'tau', 'tau_delta',
                'epsilon_cga',
                'alpha_nt', 'nu_nt', 'gamma_nt', 'mean_molecular_weight']


def _f_bar(cosmo):
    return cosmo.Omega_b / cosmo.Omega_m


def _nu_peak(cosmo, M_use, a):
    return 1.686 / _power.sigmaM(cosmo, M_use, a)


def _shared_grid(prof, like):
    """geomspace(r_min_int, r_max_int, r_steps) in jnp's rounding."""
    return torch.as_tensor(jnp_geomspace(prof.r_min_int, prof.r_max_int,
                                         prof.r_steps), device=like.device)


class Schneider25Profiles(Profile):
    """Family base (reference Schneider25.py:15-150)."""

    model_param_names = model_params
    hyper_param_names = hyper_params

    def __init__(self, r_max_int=10, **kwargs):
        super().__init__(**kwargs, r_max_int=r_max_int)

    def _get_gas_params(self, M, z):
        cdelta = 1 if self.cdelta is None else self.cdelta
        M_c = self.M_c * (1 + z) ** self.nu_M_c * cdelta ** self.zeta_M_c
        beta = 3 * (M / M_c) ** self.mu_beta / (1 + (M / M_c) ** self.mu_beta)
        theta_c = (self.theta_c * (M / self.M_theta_c) ** self.mu_theta_c
                   * (1 + z) ** self.nu_theta_c
                   * cdelta ** self.zeta_theta_c)
        delta = (self.delta * (M / self.M_delta) ** self.mu_delta
                 * (1 + z) ** self.nu_delta * cdelta ** self.zeta_delta)
        gamma = (self.gamma * (M / self.M_gamma) ** self.mu_gamma
                 * (1 + z) ** self.nu_gamma * cdelta ** self.zeta_gamma)
        alpha = (self.alpha * (M / self.M_alpha) ** self.mu_alpha
                 * (1 + z) ** self.nu_alpha * cdelta ** self.zeta_alpha)
        return (beta[:, None], theta_c[:, None], delta[:, None],
                gamma[:, None], alpha[:, None])

    def _get_star_frac(self, M_use, a, cosmo):
        eta_cga = self.eta + self.eta_delta
        tau_cga = self.tau + self.tau_delta
        fb = _f_bar(cosmo)
        f_star = self.Nstar / ((M_use / self.Mstar) ** self.tau
                               + (M_use / self.Mstar) ** self.eta)
        f_cga = self.Nstar / ((M_use / self.Mstar) ** tau_cga
                              + (M_use / self.Mstar) ** eta_cga)
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
        f_cga = self.get_f_star_cen(M_use, a, cosmo)
        fb = _f_bar(cosmo)
        f_iga = f_cga * self.c_iga * a ** (-self.nu_c_iga)
        f_iga = torch.minimum(torch.clamp(f_iga, min=1e-10), fb - f_star)
        f_hga = torch.clamp(fb - f_star - f_iga, 1e-10, fb)
        return f_hga, f_iga

    def get_f_gas(self, M, a, cosmo):
        f = self._get_gas_frac(M, a, cosmo)
        return f[0] + f[1]

    def _total_dm_mass(self, cosmo, M_use, a):
        DM = DarkMatter(**self.model_params, **self.hyper_params)
        DM.cutoff = 1e3
        r_int = _shared_grid(self, M_use)
        rho = DM._real(cosmo, r_int, M_use, a)
        return trapz(4 * math.pi * r_int ** 2 * rho, r_int)[:, None]


class DarkMatter(Schneider25Profiles):
    """Truncated NFW with a nu-dependent truncation radius, normalised
    numerically to M(<R) (reference Schneider25.py:240-310)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        c = self._get_concentration(cosmo, M_use, a)
        R = _halo_radius(self, cosmo, M_use, a)
        r_s = (R / c)[:, None]
        nu = _nu_peak(cosmo, M_use, a)
        eps = self.epsilon0 + self.epsilon1 * nu
        r_t = (R * eps)[:, None]

        r_int = _per_halo_loggrid(self.r_min_int, R, self.r_steps)
        shape_i = (1 / (r_int / r_s * (1 + r_int / r_s) ** 2)
                   / (1 + (r_int / r_t) ** 2) ** 2)
        norm = trapz(4 * math.pi * r_int ** 2 * shape_i, r_int)
        rho_c = (M_use / norm)[:, None]

        kfac = sigmoid_cutoff(rr, self.cutoff)
        return (rho_c / (rr / r_s * (1 + rr / r_s) ** 2)
                / (1 + (rr / r_t) ** 2) ** 2 * kfac)


class TwoHalo(Schneider25Profiles):
    """Two-halo term with the exclusion factor 1 - exp(-alpha_excl r/R)
    (reference Schneider25.py:340-400). xi_mm from ``correlation_3d``
    (FFTLog, kernel K8 on CUDA) unless the ``xi_mm`` hook gives it."""

    def _real(self, cosmo, r_use, M_use, a):
        R = _halo_radius(self, cosmo, M_use, a)
        if self.xi_mm is None:
            xi = _power.correlation_3d(cosmo, r_use, a=a)
        else:
            xi = self.xi_mm(r_use, a)

        delta_c = 1.686 / _core.growth_factor(cosmo, a)
        nu_M = delta_c / _power.sigmaM(cosmo, M_use, a)
        bias = (1 + (self.q * nu_M ** 2 - 1) / delta_c
                + 2 * self.p / delta_c / (1 + (self.q * nu_M ** 2) ** self.p))
        f_excl = 1 - torch.exp(-self.alpha_excl
                               * torch.clamp(r_use[None, :] / R[:, None],
                                             0, 30))
        rho_m = _core.rho_x(cosmo, a, species="matter", is_comoving=True)
        prof = f_excl * (1 + bias[:, None] * xi[None, :]) * rho_m
        return prof * sigmoid_cutoff(r_use[None, :], self.cutoff)


class Stars(Schneider25Profiles):
    """Pure exponential stars r^-2 e^{-r/R_cga} (reference
    Schneider25.py:461-494)."""

    per_halo_r = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.update_precision_fftlog(padding_lo_fftlog=1e-5,
                                     padding_hi_fftlog=1e5)

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        R = _halo_radius(self, cosmo, M_use, a)
        f_cga = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        R_cga = self.epsilon_cga * R[:, None]

        M_tot = self._total_dm_mass(cosmo, M_use, a)
        r_int = _shared_grid(self, M_use)
        shape_i = r_int[None, :] ** -2 * torch.exp(-r_int[None, :] / R_cga)
        norm = trapz(4 * math.pi * r_int ** 2 * shape_i, r_int)[:, None]

        kfac = sigmoid_cutoff(rr, self.cutoff)
        prof = rr ** -2 * torch.exp(-rr / R_cga) * kfac
        return prof * f_cga * M_tot / norm


class HotGas(Schneider25Profiles):
    """Double-slope GNFW (1+u^alpha)^(-beta/alpha) (1+v^gamma)^(-delta/gamma)
    (reference Schneider25.py:560-640)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        z = 1 / a - 1
        R = _halo_radius(self, cosmo, M_use, a)
        f_hga, _ = self._get_gas_frac(M_use, a, cosmo)
        beta, theta_c, delta, gamma, alpha = self._get_gas_params(M_use, z)
        R_c = theta_c * R[:, None]
        nu = _nu_peak(cosmo, M_use, a)[:, None]
        eps = self.epsilon0 + self.epsilon1 * nu
        R_t = eps * R[:, None]

        def shape(r):
            u = r / R_c
            v = r / R_t
            return (1 + u ** alpha) ** (-beta / alpha) \
                * (1 + v ** gamma) ** (-delta / gamma)

        r_int = _shared_grid(self, M_use)
        norm = trapz(4 * math.pi * r_int ** 2 * shape(r_int[None, :]),
                     r_int)[:, None]
        M_tot = self._total_dm_mass(cosmo, M_use, a)

        kfac = sigmoid_cutoff(rr, self.cutoff)
        prof = shape(rr) * kfac
        return prof * f_hga[:, None] * M_tot / norm


class InnerGas(Schneider25Profiles):
    """Inner gas r^-2 e^{-r/R}, divergent at r -> 0, with a hard inner cut
    at r_min_iga (reference Schneider25.py:652-671)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        R = _halo_radius(self, cosmo, M_use, a)
        _, f_iga = self._get_gas_frac(M_use, a, cosmo)

        r_int = _shared_grid(self, M_use)
        shape_i = r_int[None, :] ** -3 * torch.exp(-r_int[None, :]
                                                   / R[:, None])
        shape_i = torch.where(r_int[None, :] < self.r_min_iga,
                              torch.zeros_like(shape_i), shape_i)
        norm = trapz(4 * math.pi * r_int ** 2 * shape_i, r_int)[:, None]
        M_tot = self._total_dm_mass(cosmo, M_use, a)

        kfac = sigmoid_cutoff(rr, self.cutoff)
        prof = rr ** -2 * torch.exp(-rr / R[:, None]) * kfac
        prof = prof * f_iga[:, None] * M_tot / norm
        return torch.where(rr < self.r_min_iga, torch.zeros_like(prof), prof)


class Gas(Schneider25Profiles):
    """HotGas + InnerGas (reference Schneider25.py:700-720)."""

    per_halo_r = True

    def __init__(self, **kwargs):
        self.myprof = HotGas(**kwargs) + InnerGas(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return self.myprof._real(cosmo, r_use, M_use, a)


class CollisionlessMatter(Schneider25Profiles):
    """Relaxation without iteration: zeta = Q0 / (1 + (r/rstep)^nstep)
    + Q1 f_cga (M_cga/M_i - 1) + Q1 f_iga (M_iga/M_i - 1)
    + Q2 f_hga (M_hga/M_i - 1) + 1, applied as r zeta on one shared log grid
    (reference Schneider25.py:770-915)."""

    def __init__(self, hotgas=None, innergas=None, stars=None,
                 darkmatter=None, r_min_int=1e-8, r_max_int=1e5,
                 r_steps=5000, **kwargs):
        self.HotGas = hotgas if hotgas is not None else HotGas(**kwargs)
        self.InnerGas = (innergas if innergas is not None
                         else InnerGas(**kwargs))
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        for p_ in (self.Stars, self.HotGas, self.InnerGas, self.DarkMatter):
            p_.set_parameter('cutoff', 1000)
        super().__init__(**kwargs, r_min_int=r_min_int,
                         r_max_int=r_max_int, r_steps=r_steps)

    def _get_Qis(self, M, a, cosmo):
        z = 1 / a - 1
        return (self.q0 * (1 + z) ** self.nu_q0,
                self.q1 * (1 + z) ** self.nu_q1,
                self.q2 * (1 + z) ** self.nu_q2)

    def _real(self, cosmo, r_use, M_use, a):
        r_int = _shared_grid(self, M_use)
        lnr = torch.log(r_int)

        f_cga = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        f_sga = self.get_f_star_sat(M_use, a, cosmo)[:, None]
        f_hga, f_iga = self._get_gas_frac(M_use, a, cosmo)
        f_hga, f_iga = f_hga[:, None], f_iga[:, None]
        Q0, Q1, Q2 = self._get_Qis(M_use, a, cosmo)
        f_clm = 1 - _f_bar(cosmo) + f_sga
        nu = _nu_peak(cosmo, M_use, a)[:, None]
        eps = self.epsilon0 + self.epsilon1 * nu
        rstep = eps / self.epsilon0

        rho_i = self.DarkMatter._real(cosmo, r_int, M_use, a)
        rho_cga = self.Stars._real(cosmo, r_int, M_use, a)
        rho_hga = self.HotGas._real(cosmo, r_int, M_use, a)
        rho_iga = self.InnerGas._real(cosmo, r_int, M_use, a)

        dlnr = lnr[1] - lnr[0]
        dV = 4 * math.pi * r_int ** 3 * dlnr

        def cmass(rho):
            return (cumulative_simpson_uniform(dV[None, :] * rho, dx=1.0,
                                               axis=-1) + dV[0] * rho[:, :1])
        M_i = cmass(rho_i)
        M_cga = cmass(rho_cga)
        M_hga = cmass(rho_hga)
        M_iga = cmass(rho_iga)

        xi0 = Q0 / (1 + (r_int[None, :] / rstep) ** self.nstep)
        zeta = (xi0 + Q1 * f_cga * (M_cga / M_i - 1)
                + Q1 * f_iga * (M_iga / M_i - 1)
                + Q2 * f_hga * (M_hga / M_i - 1) + 1)

        ln_Mi = torch.log(M_i)
        d_nfw = pchip_derivatives(lnr, ln_Mi)
        ln_M_clm = torch.log(f_clm) + pchip_eval(
            lnr, ln_Mi, d_nfw, lnr[None, :] + torch.log(zeta))

        d_spl = cubic_spline_coeffs(lnr, ln_M_clm)
        ln_ru = torch.log(r_use)
        log_der = cubic_spline_derivative_eval(lnr, ln_M_clm, d_spl, ln_ru)
        ln_at = cubic_spline_eval(lnr, ln_M_clm, d_spl, ln_ru)
        prof = log_der * torch.exp(ln_at) / r_use[None, :] \
            / (4 * math.pi * r_use[None, :] ** 2)
        prof = torch.clamp(prof, min=0.0)
        outside = (ln_ru < lnr[0]) | (ln_ru > lnr[-1])
        prof = torch.where(outside[None, :], torch.zeros_like(prof), prof)
        kfac = sigmoid_cutoff(r_use[None, :], self.cutoff)
        return torch.where(torch.isfinite(prof), prof,
                           torch.zeros_like(prof)) * kfac


class SatelliteStars(CollisionlessMatter):
    """CLM rescaled to the satellite fraction."""

    def _real(self, cosmo, r_use, M_use, a):
        f_sga = self.get_f_star_sat(M_use, a, cosmo)[:, None]
        f_clm = 1 - _f_bar(cosmo) + f_sga
        return super()._real(cosmo, r_use, M_use, a) * (f_sga / f_clm)


class DarkMatterOnly(Schneider25Profiles):
    """NFW + TwoHalo (reference Schneider25.py:927-1010)."""

    def __init__(self, darkmatter=None, twohalo=None, **kwargs):
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return (self.DarkMatter._real(cosmo, r_use, M_use, a)
                + self.TwoHalo._real(cosmo, r_use, M_use, a))


class DarkMatterBaryon(Schneider25Profiles):
    """(CLM + Stars + Gas) M_DMO / M_DMB + TwoHalo (reference
    Schneider25.py:1015-1130)."""

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
        r_int = _shared_grid(self, M_use)

        rho_dmo = self.DarkMatter._real(cosmo, r_int, M_use, a)
        M_tot = trapz(4 * math.pi * r_int ** 2 * rho_dmo, r_int)
        rho_dmb = (self.CollisionlessMatter._real(cosmo, r_int, M_use, a)
                   + self.Stars._real(cosmo, r_int, M_use, a)
                   + self.Gas._real(cosmo, r_int, M_use, a))
        M_dmb = trapz(4 * math.pi * r_int ** 2 * rho_dmb, r_int)
        factor = (M_tot / M_dmb)[:, None]
        return (self.CollisionlessMatter._real(cosmo, r_use, M_use, a)
                * factor
                + self.Stars._real(cosmo, r_use, M_use, a) * factor
                + self.Gas._real(cosmo, r_use, M_use, a) * factor
                + self.TwoHalo._real(cosmo, r_use, M_use, a))
