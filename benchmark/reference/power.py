"""Linear matter power spectrum, sigma(M) and the correlation function.

Port of ``baryonforge_tpu.cosmo.power``: analytic transfer functions
(Eisenstein & Hu 1998 with and without baryon wiggles, BBKS), sigma8
normalisation, sigma(R), sigma(M) and xi(r) by FFTLog. Float64 tensors on
the device of the input (k, R, M or r); ``a`` may be a number or a
tensor.

A frozen copy of ``baryonforge_torch/cosmo/power.py`` at the commit that added
the benchmark: the benchmark's reference, which imports nothing of the
program and is not edited with it.
"""

import math

import numpy as np
import torch

from . import cosmo_core as core
from . import constants as const
from .fftlog import xi_from_pk
from .integrate import trapz

__all__ = ["K_GRID", "k_grid", "transfer_eh98", "linear_power", "sigmaR", "sigmaM",
           "sigma8_norm", "correlation_3d", "lagrangian_radius", "pk_grid",
           "dlnP_dlnk"]

# Fixed wavenumber grid (1/Mpc) of the normalisation integrals and FFTLog
K_GRID = np.geomspace(1e-5, 1e3, 1024)
_k_grids = {}


def k_grid(device):
    """``K_GRID`` as a float64 tensor on ``device`` (made once per
    device)."""
    key = str(torch.device(device))
    if key not in _k_grids:
        _k_grids[key] = torch.as_tensor(K_GRID, device=device)
    return _k_grids[key]


def _t(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


# ---------------------------------------------------------------------------
# Transfer functions (k in 1/Mpc)
# ---------------------------------------------------------------------------
def _eh98_params(cosmo):
    om, ob, h = cosmo.Omega_m, cosmo.Omega_b, cosmo.h
    oc = om - ob
    omh2, obh2 = om * h * h, ob * h * h
    theta = cosmo.T_CMB / 2.7

    z_eq = 2.50e4 * omh2 * theta ** -4
    k_eq = 7.46e-2 * omh2 * theta ** -2

    b1 = 0.313 * omh2 ** -0.419 * (1.0 + 0.607 * omh2 ** 0.674)
    b2 = 0.238 * omh2 ** 0.223
    z_d = 1291.0 * omh2 ** 0.251 / (1.0 + 0.659 * omh2 ** 0.828) \
        * (1.0 + b1 * obh2 ** b2)

    R_d = 31.5 * obh2 * theta ** -4 * (1000.0 / z_d)
    R_eq = 31.5 * obh2 * theta ** -4 * (1000.0 / z_eq)
    s = 2.0 / (3.0 * k_eq) * math.sqrt(6.0 / R_eq) * math.log(
        (math.sqrt(1.0 + R_d) + math.sqrt(R_d + R_eq))
        / (1.0 + math.sqrt(R_eq)))

    k_silk = 1.6 * obh2 ** 0.52 * omh2 ** 0.73 \
        * (1.0 + (10.4 * omh2) ** -0.95)

    a1 = (46.9 * omh2) ** 0.670 * (1.0 + (32.1 * omh2) ** -0.532)
    a2 = (12.0 * omh2) ** 0.424 * (1.0 + (45.0 * omh2) ** -0.582)
    alpha_c = a1 ** (-ob / om) * a2 ** (-(ob / om) ** 3)

    bb1 = 0.944 / (1.0 + (458.0 * omh2) ** -0.708)
    bb2 = (0.395 * omh2) ** -0.0266
    beta_c = 1.0 / (1.0 + bb1 * ((oc / om) ** bb2 - 1.0))

    y = (1.0 + z_eq) / (1.0 + z_d)
    sq = math.sqrt(1.0 + y)
    Gy = y * (-6.0 * sq + (2.0 + 3.0 * y) * math.log((sq + 1.0) / (sq - 1.0)))
    alpha_b = 2.07 * k_eq * s * (1.0 + R_d) ** -0.75 * Gy
    beta_b = 0.5 + ob / om + (3.0 - 2.0 * ob / om) \
        * math.sqrt((17.2 * omh2) ** 2 + 1.0)
    beta_node = 8.41 * omh2 ** 0.435
    return dict(k_eq=k_eq, s=s, k_silk=k_silk, alpha_c=alpha_c,
                beta_c=beta_c, alpha_b=alpha_b, beta_b=beta_b,
                beta_node=beta_node, ob_om=ob / om, oc_om=oc / om)


def _T0_tilde(q, alpha, beta):
    C = 14.2 / alpha + 386.0 / (1.0 + 69.9 * q ** 1.08)
    L = torch.log(math.e + 1.8 * beta * q)
    return L / (L + C * q * q)


def transfer_eh98(cosmo, k):
    """EH98 transfer with BAO features; k in 1/Mpc (not h/Mpc)."""
    k = _t(k)
    p = _eh98_params(cosmo)
    q = k / (13.41 * p["k_eq"])
    ks = k * p["s"]

    f = 1.0 / (1.0 + (ks / 5.4) ** 4)
    Tc = f * _T0_tilde(q, 1.0, p["beta_c"]) \
        + (1.0 - f) * _T0_tilde(q, p["alpha_c"], p["beta_c"])

    s_tilde = p["s"] / (1.0 + (p["beta_node"] / ks) ** 3) ** (1.0 / 3.0)
    x = k * s_tilde
    j0 = torch.sinc(x / math.pi)
    Tb = (_T0_tilde(q, 1.0, 1.0) / (1.0 + (ks / 5.2) ** 2)
          + p["alpha_b"] / (1.0 + (p["beta_b"] / ks) ** 3)
          * torch.exp(-(k / p["k_silk"]) ** 1.4)) * j0
    return p["ob_om"] * Tb + p["oc_om"] * Tc


_TRANSFERS = {
    "eisenstein_hu": transfer_eh98,
}


# ---------------------------------------------------------------------------
# P(k), sigma(R), sigma(M)
# ---------------------------------------------------------------------------
def _tophat_w(x):
    """3 (sin x - x cos x) / x^3, with its series below x = 1e-3."""
    small = x < 1e-3
    xs = torch.where(small, torch.ones_like(x), x)
    w = 3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / xs ** 3
    return torch.where(small, 1.0 - x * x / 10.0, w)


def _sigma2_unnorm(cosmo, R, transfer):
    """Unnormalised sigma^2(R) at a = 1 with P ~ k^ns T^2, on R's
    device."""
    R = torch.atleast_1d(_t(R))
    k = k_grid(R.device)
    T = _TRANSFERS[transfer](cosmo, k)
    pk = k ** cosmo.n_s * T * T
    integrand = k ** 3 * pk * _tophat_w(k * R[..., None]) ** 2
    return trapz(integrand, torch.log(k)) / (2.0 * math.pi ** 2)


def sigma8_norm(cosmo, transfer="eisenstein_hu", device="cpu"):
    """Amplitude A such that P(k) = A k^ns T^2 gives sigma(8/h) = sigma8,
    a 0-d tensor on ``device``."""
    s2 = _sigma2_unnorm(cosmo, torch.tensor([8.0 / cosmo.h], device=device,
                                            dtype=torch.float64),
                        transfer)[0]
    return cosmo.sigma8 ** 2 / s2


def linear_power(cosmo, k, a=1.0, transfer="eisenstein_hu"):
    """Linear matter power P(k, a) in Mpc^3 (k in 1/Mpc), on k's
    device."""
    k = _t(k)
    A = sigma8_norm(cosmo, transfer, k.device)
    T = _TRANSFERS[transfer](cosmo, k)
    D = core.growth_factor(cosmo, _t(a, k.device).to(k.device))
    return A * k ** cosmo.n_s * T * T * D.squeeze() ** 2


def pk_grid(cosmo, a=1.0, transfer="eisenstein_hu", device="cpu"):
    """(k, P(k, a)) on the fixed log grid, on ``device``."""
    k = k_grid(device)
    return k, linear_power(cosmo, k, a, transfer)


def dlnP_dlnk(cosmo, k, transfer="eisenstein_hu"):
    """Logarithmic slope of the z = 0 linear power at k (1/Mpc)."""
    k = _t(k)
    eps = 1e-3
    lp = torch.log(linear_power(cosmo, k * math.exp(eps), 1.0, transfer))
    lm = torch.log(linear_power(cosmo, k * math.exp(-eps), 1.0, transfer))
    return (lp - lm) / (2.0 * eps)


def sigmaR(cosmo, R, a=1.0, transfer="eisenstein_hu"):
    """RMS linear fluctuation in a comoving top hat of radius R (Mpc);
    mirrors R's rank."""
    R_t = _t(R)
    A = sigma8_norm(cosmo, transfer, R_t.device)
    D = core.growth_factor(cosmo, _t(a, R_t.device).to(R_t.device))
    out = torch.sqrt(A * _sigma2_unnorm(cosmo, R_t, transfer)) * D
    return out[0] if R_t.dim() == 0 else out


def lagrangian_radius(cosmo, M):
    """R_L = (3M / 4 pi rho_m0)^(1/3), comoving Mpc."""
    rho_m0 = cosmo.Omega_m * const.RHO_CRIT_0_h2 * cosmo.h ** 2
    return (3.0 * _t(M) / (4.0 * math.pi * rho_m0)) ** (1.0 / 3.0)


def sigmaM(cosmo, M, a=1.0, transfer="eisenstein_hu"):
    """sigma(M, a) on the Lagrangian scale of mass M (ccl.sigmaM)."""
    return sigmaR(cosmo, lagrangian_radius(cosmo, M), a, transfer)


def correlation_3d(cosmo, r, a=1.0, transfer="eisenstein_hu"):
    """Linear matter correlation xi(r, a) by FFTLog (ccl.correlation_3d),
    on r's device: one FFTLog transform (K8 on CUDA) of P(k) on
    ``K_GRID``."""
    r = torch.atleast_1d(_t(r))
    k, pk = pk_grid(cosmo, a, transfer, r.device)
    return xi_from_pk(k, pk, r)
