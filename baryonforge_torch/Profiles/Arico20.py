"""Arico et al. 2020 (BACCO) baryonification family (port of
``baryonforge_tpu.Profiles.Arico20``), plain torch in float64.

Distinctives against Schneider19: profiles truncated at R200c, Behroozi13
stellar fractions with fixed calibration constants, gas split into bound,
ejected and re-accreted components, an analytic NFW normalisation and a
polytropic pressure model.

The collisionless matter relaxes on a log grid of each halo's own, from
r_min_int to its R (the JAX package vmaps its components over the rows),
built with R on the host so that its last point falls on the same side
of the truncations at R on every device (``Base._host_halo_radius``):
the components that are elementwise in r (``per_halo_r``) take the (M, L)
grid in one call (``Base.eval_rows``), and the PCHIPs and the not-a-knot
spline run with knots of their own a row (``ops.interp``).
``ModifiedDarkMatter``'s r_p is one root a halo of a batched root-find
(``utils.misc.safe_Pchip_minimize``).
"""

import math

import torch

from .Base import (Profile, hyper_params, sigmoid_cutoff, _rows, eval_rows,
                   _halo_radius, _per_halo_loggrid, _host_halo_radius,
                   _host_per_halo_loggrid)
from . import Schneider19 as S19
from .misc import Truncation
from ..cosmo import power as _power
from ..cosmo import massdef as _massdef
from ..cosmo import concentration as _conc
from ..ops.grids import jnp_geomspace
from ..ops.integrate import cumulative_simpson_uniform, trapz
from ..ops.interp import (pchip_derivatives, pchip_eval, cubic_spline_coeffs,
                          cubic_spline_derivative_eval, cubic_spline_eval)
from ..utils import constants as const
from ..utils.misc import safe_Pchip_minimize

__all__ = ['model_params', 'AricoProfiles', 'DarkMatter', 'TwoHalo',
           'Stars', 'BoundGasUntruncated', 'BoundGas', 'EjectedGas',
           'ReaccretedGas', 'Gas', 'ModifiedDarkMatter',
           'CollisionlessMatter', 'SatelliteStars', 'DarkMatterOnly',
           'DarkMatterBaryon', 'DarkMatterOnlywithLSS',
           'DarkMatterBaryonwithLSS', 'Pressure', 'NonThermalFrac',
           'ThermalPressure', 'Temperature', 'BoundGasDeprecated']

# parameter inventory of the reference (Arico20.py:16-28)
model_params = ['cdelta', 'a', 'n',
                'q', 'p',
                'cutoff', 'proj_cutoff',
                'theta_out', 'theta_inn', 'M_inn', 'M_c', 'mu', 'beta',
                'M_r', 'beta_r', 'eta', 'theta_rg', 'sigma_rg',
                'epsilon_hydro',
                'M1_0', 'alpha_g', 'epsilon_h',
                'M1_fsat', 'eps_fsat', 'alpha_fsat', 'delta_fsat',
                'gamma_fsat',
                'A_nt', 'alpha_nt',
                'mean_molecular_weight']

# Behroozi+2013 fitting-function calibration constants (Arico20.py:129-143)
_B13 = dict(M1_a=-1.793, M1_z=-0.251, eps_0=math.log10(0.023), eps_a=-0.006,
            eps_a2=-0.119, alpha_0=-1.779, alpha_a=0.731, delta_0=4.394,
            delta_a=2.608, delta_z=-0.043, gamma_0=0.547, gamma_a=1.319,
            gamma_z=0.279)


def _f_bar(cosmo):
    return cosmo.Omega_b / cosmo.Omega_m


def _zero_outside(prof, rr, R):
    """prof where r <= R, else 0."""
    return torch.where(rr <= R[:, None], prof, torch.zeros_like(prof))


class AricoProfiles(Profile):
    """Family base: Behroozi13 stellar fractions and the bound / ejected /
    re-accreted gas split (reference Arico20.py:31-261)."""

    model_param_names = model_params
    hyper_param_names = hyper_params

    def __init__(self, r_max_int=10, **kwargs):
        super().__init__(**kwargs, r_max_int=r_max_int)

    def _get_gas_params(self, M, a, cosmo):
        beta = 3.0 - (self.M_inn / M) ** self.mu * torch.ones_like(M)
        beta = torch.clamp(beta, min=-1)
        theta_out = self.theta_out * torch.ones_like(M)
        theta_inn = self.theta_inn * torch.ones_like(M)
        return beta[:, None], theta_out[:, None], theta_inn[:, None]

    def _behroozi_frac(self, M, a, M1_0, eps_fac=1.0, alpha_fac=1.0,
                       delta_fac=1.0, gamma_fac=1.0):
        B = _B13
        z = 1 / a - 1
        nu = math.exp(-4 * a ** 2)
        M1 = M1_0 * 10 ** ((B["M1_a"] * (a - 1) + B["M1_z"] * z) * nu)
        eps = 10 ** (B["eps_0"] + nu * (B["eps_a"] * (a - 1))
                     + B["eps_a2"] * (a - 1)) * eps_fac
        alpha = (B["alpha_0"] + nu * (B["alpha_a"] * (a - 1))) * alpha_fac
        delta = (B["delta_0"] + nu * (B["delta_a"] * (a - 1)
                                      + B["delta_z"] * z)) * delta_fac
        gamma = (B["gamma_0"] + nu * (B["gamma_a"] * (a - 1)
                                      + B["gamma_z"] * z)) * gamma_fac

        x = torch.log10(M / M1)
        exp_term = torch.exp(torch.clamp(10.0 ** (-x), max=30.0))
        g_x = (-torch.log10(10 ** (alpha * x) + 1)
               + delta * torch.log10(1 + torch.exp(x)) ** gamma
               / (1 + exp_term))
        g_0 = (-math.log10(2.0)
               + delta * math.log10(2.0) ** gamma / (1 + math.e))
        return eps * (M1 / M) * 10 ** (g_x - g_0)

    def _get_star_frac(self, M, a, cosmo, satellite=False):
        fCG = self._behroozi_frac(M, a, self.M1_0)
        fSG = self._behroozi_frac(M, a, self.M1_0 * self.M1_fsat,
                                  self.eps_fsat, self.alpha_fsat,
                                  self.delta_fsat, self.gamma_fsat)
        fb = _f_bar(cosmo)
        fCG = torch.clamp(fCG, 1e-10, fb)
        fSG = torch.clamp(fSG - torch.clamp(fCG + fSG - fb, min=0), min=0)
        return fSG if satellite else fCG

    def get_f_star(self, M_use, a, cosmo):
        return (self.get_f_star_cen(M_use, a, cosmo)
                + self.get_f_star_sat(M_use, a, cosmo))

    def get_f_star_cen(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo, satellite=False)

    def get_f_star_sat(self, M_use, a, cosmo):
        return self._get_star_frac(M_use, a, cosmo, satellite=True)

    def _get_gas_frac(self, M, a, cosmo):
        """(f_bg, f_rg, f_eg) bound / re-accreted / ejected gas fractions
        (reference Arico20.py:238-244)."""
        f_str = self.get_f_star(M, a, cosmo)
        f_gas = torch.clamp(_f_bar(cosmo) - f_str, min=1e-10)
        f_hg = f_gas / (1 + (self.M_c / M) ** self.beta)
        f_eg = f_gas - f_hg
        f_rg = torch.minimum(f_eg / (1 + (self.M_r / M) ** self.beta_r),
                             f_hg)
        f_bg = f_hg - f_rg
        return f_bg, f_rg, f_eg

    def get_f_gas(self, M, a, cosmo):
        f = self._get_gas_frac(M, a, cosmo)
        return f[0] + f[1] + f[2]


class DarkMatter(AricoProfiles):
    """NFW truncated at R with the analytic normalisation (reference
    Arico20.py:264-331)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        c = self._get_concentration(cosmo, M_use, a)
        R = _host_halo_radius(self, cosmo, M_use, a)
        r_s = R / c
        norm = 4 * math.pi * r_s ** 3 * _massdef.nfw_mu(c)
        rho_c = (M_use / norm)[:, None]
        r_s = r_s[:, None]

        kfac = sigmoid_cutoff(rr, self.cutoff)
        prof = rho_c / (rr / r_s * (1 + rr / r_s) ** 2) * kfac
        return _zero_outside(prof, rr, R)


class TwoHalo(S19.TwoHalo, AricoProfiles):
    """Same two-halo term as Schneider19 (reference Arico20.py:334-335)."""
    model_param_names = model_params


class Stars(AricoProfiles):
    """Power law times Gaussian stellar profile (reference
    Arico20.py:338-406)."""

    per_halo_r = True

    def __init__(self, r_min_int=1e-6, r_max_int=5, **kwargs):
        super().__init__(**{**kwargs, "r_min_int": r_min_int},
                         r_max_int=r_max_int)
        self.update_precision_fftlog(padding_lo_fftlog=1e-5,
                                     padding_hi_fftlog=1e5,
                                     plaw_fourier=-3 + 1e-4)

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        R = _halo_radius(self, cosmo, M_use, a)
        f_cga = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        R_h = self.epsilon_h * R[:, None]

        r_int = torch.as_tensor(jnp_geomspace(self.r_min_int, self.r_max_int,
                                              self.r_steps),
                                device=M_use.device)
        shape_i = (1 / R_h / r_int[None, :] ** self.alpha_g
                   * torch.exp(-(r_int[None, :] / 2 / R_h) ** 2))
        norm = trapz(4 * math.pi * r_int ** 2 * shape_i, r_int)[:, None]
        return (f_cga * M_use[:, None] / R_h / rr ** self.alpha_g
                * torch.exp(-(rr / 2 / R_h) ** 2) / norm)


class BoundGasUntruncated(AricoProfiles):
    """Double-slope bound gas with a matched NFW tail outside R_ej
    (reference Arico20.py:409-515), normalised on [r_min, R] a halo."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        R = _halo_radius(self, cosmo, M_use, a)
        f_bg = self._get_gas_frac(M_use, a, cosmo)[0][:, None]
        beta, theta_out, theta_inn = self._get_gas_params(M_use, a, cosmo)
        R_co = theta_inn * R[:, None]
        R_ej = theta_out * R[:, None]

        c = self._get_concentration(cosmo, M_use, a)
        r_s = (R / c)[:, None]
        # the constant matching the GNFW to the NFW tail at R_ej
        y1 = ((1 + R_ej / R_co) ** -beta / 4 * (R_ej / r_s)
              * (1 + R_ej / r_s) ** 2)

        r_int = _per_halo_loggrid(self.r_min_int, R, self.r_steps)
        u_i = r_int / R_co
        v_i = r_int / R_ej
        shape_i = (1 + u_i) ** -beta / (1 + v_i ** 2) ** 2
        norm = trapz(4 * math.pi * r_int ** 2 * shape_i, r_int)[:, None]

        u = rr / R_co
        v = rr / R_ej
        x = rr / r_s
        gnfw = (1 + u) ** -beta / (1 + v ** 2) ** 2
        nfw = y1 / x / (1 + x) ** 2
        prof = torch.where(v <= 1, gnfw, nfw)
        prof = prof * f_bg * M_use[:, None] / norm
        return prof * sigmoid_cutoff(rr, self.cutoff)


class BoundGas(BoundGasUntruncated):
    """Bound gas truncated at R (reference Arico20.py:518-556)."""

    def _real(self, cosmo, r_use, M_use, a):
        trunc = Truncation(epsilon_trunc=1, mass_def=self.mass_def)
        return super()._real(cosmo, r_use, M_use, a) \
            * trunc._real(cosmo, r_use, M_use, a)


class EjectedGas(AricoProfiles):
    """Gaussian ejected gas with R_ej from the escape radius (reference
    Arico20.py:560-618)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        if self.mass_def.rho_type != "critical":
            raise ValueError("the escape radius needs a critical-overdensity "
                             "mass definition")
        rr = _rows(r_use)
        R = _halo_radius(self, cosmo, M_use, a)
        f_eg = self._get_gas_frac(M_use, a, cosmo)[2][:, None]
        R_esc = 0.5 * math.sqrt(self.mass_def.Delta) * R
        R_ej = (self.eta * 0.75 * R_esc)[:, None]

        kfac = sigmoid_cutoff(rr, self.cutoff)
        return (f_eg * M_use[:, None] / (2 * math.pi * R_ej ** 2) ** 1.5
                * torch.exp(-(rr / R_ej) ** 2 / 2) * kfac)


class ReaccretedGas(AricoProfiles):
    """Gaussian shell at theta_rg R with the analytic erf normalisation,
    zero beyond R (reference Arico20.py:622-688)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        R = _host_halo_radius(self, cosmo, M_use, a)
        f_rg = self._get_gas_frac(M_use, a, cosmo)[1][:, None]
        R_rg = (self.theta_rg * R)[:, None]
        S_rg = (self.sigma_rg * R)[:, None]
        Rc = R[:, None]

        erf = torch.special.erf
        t1 = 2 * math.sqrt(2 * math.pi) * (
            torch.exp(-R_rg ** 2 / (2 * S_rg ** 2)) * R_rg
            - torch.exp(-(R_rg - Rc) ** 2 / (2 * S_rg ** 2)) * (R_rg + Rc))
        t2 = 2 * math.pi * (R_rg ** 2 + S_rg ** 2) \
            * erf(R_rg / (math.sqrt(2.0) * S_rg))
        t3 = -2 * math.pi * (R_rg ** 2 + S_rg ** 2) \
            * erf((R_rg - Rc) / (math.sqrt(2.0) * S_rg))
        norm = t1 * S_rg + t2 + t3

        kfac = sigmoid_cutoff(rr, self.cutoff)
        prof = (1 / torch.sqrt(2 * math.pi * S_rg ** 2)
                * torch.exp(-((rr - R_rg) / S_rg) ** 2 / 2))
        prof = prof * f_rg * M_use[:, None] / norm * kfac
        return _zero_outside(prof, rr, R)


class Gas(AricoProfiles):
    """BoundGas + EjectedGas + ReaccretedGas by profile algebra (reference
    Arico20.py:691-711)."""

    per_halo_r = True

    def __init__(self, **kwargs):
        self.myprof = (BoundGas(**kwargs) + EjectedGas(**kwargs)
                       + ReaccretedGas(**kwargs))
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return self.myprof._real(cosmo, r_use, M_use, a)


class ModifiedDarkMatter(AricoProfiles):
    """DM adjusted for the gas: NFW inside r_p, rho_Gro - rho_BG outside,
    zero beyond R; r_p from eq. A10 of arXiv:1911.08471, one root a halo
    (reference Arico20.py:714-817)."""

    per_halo_r = True

    def __init__(self, gas=None, gravityonly=None, **kwargs):
        self.Gas = gas if gas is not None else BoundGas(**kwargs)
        self.GravityOnly = (gravityonly if gravityonly is not None
                            else DarkMatter(**kwargs))
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        c = self._get_concentration(cosmo, M_use, a)
        R = _host_halo_radius(self, cosmo, M_use, a)
        r_s = (R / c)[:, None]
        fDM = 1 - _f_bar(cosmo)

        rp_grid = torch.as_tensor(jnp_geomspace(
            self.r_min_int, self.r_max_int, self.r_steps),
            device=M_use.device)
        # the densities at each halo's own boundary
        pGro = eval_rows(self.GravityOnly, cosmo, R[:, None], M_use, a)
        pBG = eval_rows(self.Gas, cosmo, R[:, None], M_use, a)

        rpg = rp_grid[None, :]
        LHS = (rpg * (rpg + r_s) ** 2 * (pGro - pBG)
               * (torch.log(1 + rpg / r_s) - 1 / (1 + r_s / rpg))
               + (pGro - pBG) / 3 * (R[:, None] ** 3 - rpg ** 3))
        RHS = (fDM * M_use / (4 * math.pi))[:, None]
        ln_rp = safe_Pchip_minimize(LHS - RHS, torch.log(rp_grid))
        rp = torch.exp(ln_rp)[:, None]

        rho_c = (pGro - pBG) * (rp / r_s) * (1 + rp / r_s) ** 2
        prof = rho_c / (rr / r_s) / (1 + rr / r_s) ** 2
        prof = torch.where(rr < rp, prof, pGro - pBG)
        prof = prof * sigmoid_cutoff(rr, self.cutoff)
        return _zero_outside(prof, rr, R)


def _masked(values, x, lnr, fill):
    """values where x lies on each row's grid lnr, else fill."""
    inside = (x >= lnr[:, :1]) & (x <= lnr[:, -1:])
    return torch.where(inside, values, fill)


class CollisionlessMatter(AricoProfiles):
    """Relaxed collisionless matter on per-halo grids to R200c, the
    relaxation normalised to 1 at R and the mass renormalised to f_clm M at
    R (reference Arico20.py:820-975): exactly ``max_iter`` relaxation steps
    over all halos at once, no early exit (as the JAX fori_loop)."""

    def __init__(self, gas=None, stars=None, darkmatter=None, max_iter=10,
                 reltol=1e-2, r_min_int=1e-8, r_max_int=10.0, r_steps=5000,
                 **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else ModifiedDarkMatter(**kwargs))
        self.Gas.set_parameter('cutoff', 1000)
        self.Stars.set_parameter('cutoff', 1000)
        self.DarkMatter.set_parameter('cutoff', 1000)
        self.max_iter = max_iter
        self.reltol = reltol
        super().__init__(**kwargs, r_min_int=r_min_int,
                         r_max_int=r_max_int, r_steps=r_steps)

    def _real(self, cosmo, r_use, M_use, a):
        R = _host_halo_radius(self, cosmo, M_use, a)
        f_sg = self.get_f_star_sat(M_use, a, cosmo)[:, None]
        f_clm = (1 - _f_bar(cosmo)) + f_sg

        r_int = _host_per_halo_loggrid(self.r_min_int, R, self.r_steps)
        lnr = torch.log(r_int)
        dlnr = lnr[:, 1:2] - lnr[:, 0:1]

        gas = self.Gas.myprof if isinstance(self.Gas, Gas) else self.Gas
        rho_i = eval_rows(self.DarkMatter, cosmo, r_int, M_use, a)
        rho_cga = eval_rows(self.Stars, cosmo, r_int, M_use, a)
        rho_gas = eval_rows(gas, cosmo, r_int, M_use, a)

        dV = 4 * math.pi * r_int ** 3 * dlnr

        def cmass(rho):
            return (cumulative_simpson_uniform(dV * rho, dx=1.0, axis=-1)
                    + dV[:, :1] * rho[:, :1])
        M_i = cmass(rho_i)
        M_cga = cmass(rho_cga)
        M_gas = cmass(rho_gas)

        ln_Mi = torch.log(M_i)
        ln_Mc = torch.log(M_cga)
        ln_Mg = torch.log(M_gas)
        d_nfw = pchip_derivatives(lnr, ln_Mi)
        d_cga = pchip_derivatives(lnr, ln_Mc)
        d_gas = pchip_derivatives(lnr, ln_Mg)

        zeta = torch.ones_like(M_i)
        for _ in range(self.max_iter):
            ln_rf = lnr + torch.log(zeta)
            Mc = _masked(torch.exp(pchip_eval(lnr, ln_Mc, d_cga, ln_rf)),
                         ln_rf, lnr, M_cga[:, -1:])
            Mg = _masked(torch.exp(pchip_eval(lnr, ln_Mg, d_gas, ln_rf)),
                         ln_rf, lnr, M_gas[:, -1:])
            M_f = f_clm * M_i + Mc + Mg
            znew = 1 + self.a * ((M_i / M_f) ** self.n - 1)
            # normalised to 1 at R, the last grid point (Arico20.py:920-923)
            zeta = znew / znew[:, -1:]

        ln_shift = lnr - torch.log(zeta)
        shifted = _masked(pchip_eval(lnr, ln_Mi, d_nfw, ln_shift), ln_shift,
                          lnr, torch.zeros_like(ln_shift))
        ln_M_clm = torch.log(f_clm) + shifted
        # renormalised to f_clm M at R (Arico20.py:950-952)
        ln_M_clm = ln_M_clm + (torch.log(f_clm * M_use[:, None])
                               - ln_M_clm[:, -1:])

        # the density from d/dr of each halo's spline, knots of its own
        d_spl = cubic_spline_coeffs(lnr, ln_M_clm)
        ln_r = torch.log(r_use)
        logd = cubic_spline_derivative_eval(lnr, ln_M_clm, d_spl, ln_r)
        ln_at = cubic_spline_eval(lnr, ln_M_clm, d_spl, ln_r)
        r_out = r_use[None, :]
        rho = logd * torch.exp(ln_at) / r_out / (4 * math.pi * r_out ** 2)
        inside = ((ln_r[None, :] >= lnr[:, :1])
                  & (ln_r[None, :] <= lnr[:, -1:]) & (r_out <= R[:, None]))
        rho = torch.where(inside, rho, torch.zeros_like(rho))
        prof = torch.where(torch.isfinite(rho), rho, torch.zeros_like(rho))
        prof = torch.clamp(prof, min=0.0)
        return prof * sigmoid_cutoff(r_out, self.cutoff)


class SatelliteStars(CollisionlessMatter):
    """CLM rescaled to the satellite fraction (reference Arico20.py:978)."""

    def _real(self, cosmo, r_use, M_use, a):
        f_sg = self.get_f_star_sat(M_use, a, cosmo)[:, None]
        f_clm = (1 - _f_bar(cosmo)) + f_sg
        return super()._real(cosmo, r_use, M_use, a) * (f_sg / f_clm)


class DarkMatterOnly(DarkMatter):
    """= DarkMatter: Arico's DMO has no two-halo term (reference
    Arico20.py:993)."""


class DarkMatterBaryon(AricoProfiles):
    """Gas + Stars + CLM, no renormalisation factor (reference
    Arico20.py:1000-1015)."""

    def __init__(self, gas=None, stars=None, collisionlessmatter=None,
                 **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.CollisionlessMatter = (collisionlessmatter
                                    if collisionlessmatter is not None
                                    else CollisionlessMatter(**kwargs))
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return (self.Gas._real(cosmo, r_use, M_use, a)
                + self.Stars._real(cosmo, r_use, M_use, a)
                + self.CollisionlessMatter._real(cosmo, r_use, M_use, a))


class DarkMatterOnlywithLSS(AricoProfiles):
    """DarkMatter + TwoHalo (reference Arico20.py:1018-1032)."""

    def __init__(self, darkmatter=None, twohalo=None, **kwargs):
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return (self.DarkMatter._real(cosmo, r_use, M_use, a)
                + self.TwoHalo._real(cosmo, r_use, M_use, a))


class DarkMatterBaryonwithLSS(DarkMatterBaryon):
    """DMB + TwoHalo (reference Arico20.py:1035-1049)."""

    def __init__(self, gas=None, stars=None, collisionlessmatter=None,
                 darkmatter=None, twohalo=None, **kwargs):
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        super().__init__(gas=gas, stars=stars,
                         collisionlessmatter=collisionlessmatter, **kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return (super()._real(cosmo, r_use, M_use, a)
                + self.TwoHalo._real(cosmo, r_use, M_use, a))


class Pressure(AricoProfiles):
    """Polytropic effective-EoS pressure applied to all gas (reference
    Arico20.py:1052-1174): Gamma_eff from c theta_out, P0 per eq. 5 of
    arXiv:2406.01672, in CGS with the 1/a comoving factor."""

    per_halo_r = True

    def __init__(self, bound_gas_untruncated=None, gas=None, **kwargs):
        self.BoundGas = (bound_gas_untruncated
                         if bound_gas_untruncated is not None
                         else BoundGasUntruncated(**kwargs))
        self.Gas = gas if gas is not None else Gas(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        R = _halo_radius(self, cosmo, M_use, a)
        c = self._get_concentration(cosmo, M_use, a)[:, None]
        r_s = R[:, None] / c
        norm = 4 * math.pi * r_s ** 3 * _massdef.nfw_mu(c)
        rhoc = M_use[:, None] / norm

        xp = c * self.theta_out
        Geff = 1 + ((1 + xp) * torch.log(1 + xp) - xp) \
            / ((1 + 3 * xp) * torch.log(1 + xp))
        rho0 = self.BoundGas._real(
            cosmo, torch.tensor([1e-10], dtype=torch.float64,
                                device=M_use.device), M_use, a)
        P0 = rhoc * r_s ** 2 / rho0 ** (Geff - 1) * (1 - 1 / Geff)
        P0 = P0 * 4 * math.pi * const.G
        # (Msun/Mpc) -> CGS (g/cm): G rho^2 L^2 -> erg/cm^3
        P0 = P0 * const.Msun_to_g / const.Mpc_to_cm
        P0 = P0 / a

        rhoBG = self.BoundGas._real(cosmo, r_use, M_use, a)
        rhoG = self.Gas._real(cosmo, r_use, M_use, a)
        prof = P0 * rhoBG ** Geff
        prof = torch.where(torch.isfinite(prof), prof, torch.zeros_like(prof))
        rhoBG = torch.where(rhoBG > 0, rhoBG, torch.full_like(rhoBG,
                                                             math.inf))
        prof = rhoG * (prof / rhoBG)
        return prof * sigmoid_cutoff(rr, self.cutoff)


class NonThermalFrac(AricoProfiles):
    """Green20 functional form with the free amplitude A_nt (1+z)^alpha_nt,
    through the M200m translation and the peak height (reference
    Arico20.py:1177)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        z = 1 / a - 1
        conc = _conc.ConcentrationDiemer15(mass_def=self.mass_def)
        c_in = conc(cosmo, M_use, a)
        M200m, _ = _massdef.translate_mass(cosmo, M_use, a, c_in,
                                           self.mass_def,
                                           _massdef.MassDef200m)
        R200m = (_massdef.MassDef200m.get_radius(cosmo, M200m, a) / a).to(
            M_use.device)
        x = _rows(r_use) / R200m[:, None]
        nu_M = (1.686 / _power.sigmaM(cosmo, M200m, a))[:, None]
        b, cc, d, e, f = 0.719, 1.417, -0.166, 0.265, -2.116
        A = self.A_nt * (1 + z) ** self.alpha_nt
        nth = 1 - A * (1 + torch.exp(-(x / b) ** cc)) \
            * (nu_M / 4.1) ** (d / (1 + (x / e) ** f))
        return torch.clamp(nth, 0.0, 1.0)


class ThermalPressure(AricoProfiles):
    """Pressure * (1 - NonThermalFrac) (reference Arico20.py:1246-1254)."""

    per_halo_r = True

    def __init__(self, **kwargs):
        self.Pressure = Pressure(**kwargs)
        self.NonThermalFrac = NonThermalFrac(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r_use, M_use, a):
        return (self.Pressure._real(cosmo, r_use, M_use, a)
                * (1 - self.NonThermalFrac._real(cosmo, r_use, M_use, a)))


class Temperature(AricoProfiles):
    """Ideal-gas temperature P / (n k_B) in K (reference
    Arico20.py:1257)."""

    per_halo_r = True

    def __init__(self, pressure=None, gas=None, **kwargs):
        self.Pressure = (pressure if pressure is not None
                         else ThermalPressure(**kwargs))
        self.Gas = gas if gas is not None else Gas(**kwargs)
        super().__init__(**kwargs)

    def _number_density(self, rho):
        # rho [Msun/Mpc^3] -> n [1/cm^3]
        return rho * const.Msun_to_g / const.Mpc_to_cm ** 3 \
            / (self.mean_molecular_weight * const.M_PROTON_CGS)

    def _temperature(self, P, rho):
        n = self._number_density(rho)
        return torch.where(n > 0, P / (n * const.K_BOLTZ_CGS),
                           torch.zeros_like(P))

    def _real(self, cosmo, r_use, M_use, a):
        return self._temperature(self.Pressure._real(cosmo, r_use, M_use, a),
                                 self.Gas._real(cosmo, r_use, M_use, a))

    def _projected(self, cosmo, r, M, a, **kw):
        return self._temperature(
            self.Pressure._projected(cosmo, r, M, a, **kw),
            self.Gas._projected(cosmo, r, M, a, **kw))


class BoundGasDeprecated(AricoProfiles):
    """Legacy hydrostatic / NFW-tail bound gas, kept for API compatibility
    (reference Arico20.py:1339-1440)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        rr = _rows(r_use)
        R = _halo_radius(self, cosmo, M_use, a)
        f_cg = self.get_f_star_cen(M_use, a, cosmo)[:, None]
        fb = _f_bar(cosmo)
        f_bg = ((fb - f_cg)
                / (1 + (self.M_c / M_use[:, None]) ** self.beta))

        c = self._get_concentration(cosmo, M_use, a)
        r_s = (R / c)[:, None]
        eps = self.epsilon_hydro
        ce = c / eps
        Geff = ((1 + 3 * ce) * torch.log(1 + ce)
                / ((1 + ce) * torch.log(1 + ce) - ce))[:, None]
        e5 = (c / eps)[:, None]
        y1 = (torch.log(1 + e5) / e5) ** Geff * (e5 * (1 + e5) ** 2)

        def shape(r):
            x = r / r_s
            u = (torch.log(1 + x) / x) ** Geff
            v = y1 * (1 + x) ** -2 / x
            y = torch.where(r < R[:, None] / eps, u, v)
            return torch.where(r > R[:, None], torch.zeros_like(y), y)

        r_int = torch.as_tensor(jnp_geomspace(self.r_min_int, self.r_max_int,
                                              self.r_steps),
                                device=M_use.device)
        norm = trapz(4 * math.pi * r_int ** 2 * shape(r_int[None, :]),
                     r_int)[:, None]
        prof = f_bg * M_use[:, None] * shape(rr) / norm
        return prof * sigmoid_cutoff(rr, self.cutoff)
