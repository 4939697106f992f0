"""Halo-model calculator with M_delta != M_tot support (port of
``baryonforge_tpu.utils.halomodel``; reference utils/halomodel.py).

The mass functions and bias (Sheth-Tormen 1999, Tinker 2008) and the
calculator's integrals

    I = ∫ dM n(M, a) f(M, k, a)

with the counter terms of the reference (halomodel.py:47-76):

    n_0 = (rho_m - ∫ n M_tot dM) / M_tot,min          (mass conservation)
    b_0 = (rho_m - ∫ n b M_tot dM) / M_tot,min        (bias consistency)

in torch float64. A mass function or bias called with a tensor ``M``
runs on its device, else on the object's ``device`` ("cuda" by default);
the calculator's mass grid lives on its ``device``. ``prof.fourier`` is
the port's FFTLog (kernel K8 on CUDA).
"""

import math

import numpy as np
import torch

from ..cosmo import core as _core
from ..cosmo import power as _power
from ..cosmo import massdef as _massdef

__all__ = ["MassFuncShethTormen", "MassFuncTinker08", "HaloBiasShethTormen",
           "FlexibleHMCalculator", "halomodel_power"]

_DELTA_C = 1.686


def _device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("halomodel: device='cuda' but CUDA is not "
                           "available; pass device='cpu'")
    return dev


def _mass(M, device):
    """M as an at-least-1-D float64 tensor: on its own device when it is a
    tensor, else on ``device``."""
    if isinstance(M, torch.Tensor):
        return torch.atleast_1d(M.to(torch.float64))
    return torch.atleast_1d(torch.as_tensor(np.asarray(M, dtype=np.float64),
                                            device=_device(device)))


def _rho_m0(cosmo):
    return float(_core.rho_x(cosmo, 1.0, "matter", is_comoving=True))


def _dlnsig_dlnM(cosmo, M, a):
    eps = 1e-3
    lp = torch.log(_power.sigmaM(cosmo, M * math.exp(eps), a))
    lm = torch.log(_power.sigmaM(cosmo, M * math.exp(-eps), a))
    return (lp - lm) / (2 * eps)


class MassFuncShethTormen:
    """Sheth & Tormen 1999 dn/dlog10M [Mpc^-3] (comoving)."""

    def __init__(self, mass_def=_massdef.MassDef200m, A=0.3222, a_st=0.707,
                 p=0.3, device="cuda"):
        self.mass_def = mass_def
        self.A, self.a_st, self.p = A, a_st, p
        self.device = device

    def __call__(self, cosmo, M, a):
        M = _mass(M, self.device)
        sig = _power.sigmaM(cosmo, M, a)
        nu = _DELTA_C / sig
        anu2 = self.a_st * nu ** 2
        f = (self.A * torch.sqrt(2 * anu2 / math.pi)
             * (1 + anu2 ** -self.p) * torch.exp(-anu2 / 2))
        dlns = -_dlnsig_dlnM(cosmo, M, a)
        # dn/dlog10M = f(nu) rho_m/M * dln sigma^-1/dlog10 M
        return f * _rho_m0(cosmo) / M * dlns * math.log(10.0)


class MassFuncTinker08:
    """Tinker et al. 2008 dn/dlog10M for Delta=200m."""

    def __init__(self, mass_def=_massdef.MassDef200m, device="cuda"):
        self.mass_def = mass_def
        # Delta = 200 (matter) calibration row
        self.A0, self.a0, self.b0, self.c0 = 0.186, 1.47, 2.57, 1.19
        self.device = device

    def __call__(self, cosmo, M, a):
        M = _mass(M, self.device)
        z = np.clip(1.0 / np.asarray(a, dtype=np.float64) - 1.0, 0.0, 3.0)
        z = float(z) if z.ndim == 0 else torch.as_tensor(z, device=M.device)
        sig = _power.sigmaM(cosmo, M, a)
        A = self.A0 * (1 + z) ** -0.14
        aa = self.a0 * (1 + z) ** -0.06
        alpha = 10 ** (-((0.75 / math.log10(200 / 75.0)) ** 1.2))
        b = self.b0 * (1 + z) ** -alpha
        c = self.c0
        f = A * ((sig / b) ** -aa + 1) * torch.exp(-c / sig ** 2)
        dlns = -_dlnsig_dlnM(cosmo, M, a)
        return f * _rho_m0(cosmo) / M * dlns * math.log(10.0)


class HaloBiasShethTormen:
    """Sheth & Tormen 1999 peak-background-split bias."""

    def __init__(self, mass_def=_massdef.MassDef200m, a_st=0.707, p=0.3,
                 device="cuda"):
        self.mass_def = mass_def
        self.a_st, self.p = a_st, p
        self.device = device

    def __call__(self, cosmo, M, a):
        M = _mass(M, self.device)
        nu = _DELTA_C / _power.sigmaM(cosmo, M, a)
        anu2 = self.a_st * nu ** 2
        return (1 + (anu2 - 1) / _DELTA_C
                + 2 * self.p / _DELTA_C / (1 + anu2 ** self.p))


class FlexibleHMCalculator:
    """Halo-model integrals with the M_delta/M_tot distinction
    (reference utils/halomodel.py:47-76), over ``nM`` masses log-spaced
    from 10^log10M_min to 10^log10M_max, on ``device``."""

    def __init__(self, *, mass_function, halo_bias, halo_m_to_mtot=None,
                 mass_def=_massdef.MassDef200m, log10M_min=8.0,
                 log10M_max=16.0, nM=128, device="cuda"):
        self.mass_function = mass_function
        self.halo_bias = halo_bias
        self.halo_m_to_mtot = halo_m_to_mtot
        self.mass_def = mass_def
        self.device = _device(device)
        self._mass = torch.as_tensor(np.geomspace(10.0 ** log10M_min,
                                                  10.0 ** log10M_max, nM),
                                     device=self.device)
        self._lmass = torch.log10(self._mass)

    def _weights(self, cosmo, a):
        rho0 = _rho_m0(cosmo)
        nM = self.mass_function(cosmo, self._mass, a)     # dn/dlog10M
        if self.halo_m_to_mtot is not None:
            mtot = torch.as_tensor(
                self.halo_m_to_mtot(cosmo, self._mass, a),
                dtype=torch.float64).to(self.device)
        else:
            mtot = self._mass
        # counter terms: unresolved low-mass halos carry the missing mass
        integ_m = torch.trapezoid(nM * mtot, self._lmass)
        mf0 = (rho0 - integ_m) / mtot[0]
        bf = self.halo_bias(cosmo, self._mass, a)
        integ_b = torch.trapezoid(nM * bf * mtot, self._lmass)
        mbf0 = (rho0 - integ_b) / mtot[0]
        return nM, bf, mf0, mbf0

    def _fourier(self, cosmo, k, a, prof):
        """u(k, M) (nM, nk) on the calculator's device."""
        if not isinstance(k, torch.Tensor):
            k = torch.as_tensor(np.asarray(k, dtype=np.float64))
        k = k.to(self.device, torch.float64)
        return torch.atleast_2d(prof.fourier(cosmo, k, self._mass, a))

    def integrate_over_massfunc(self, func, cosmo, a):
        """∫ dn/dlog10M func(M) dlog10M + counter term."""
        nM, _, mf0, _ = self._weights(cosmo, a)
        fM = func(self._mass)
        return torch.trapezoid(nM * fM, self._lmass) + mf0 * func(
            self._mass[:1])[0]

    def I_0_1(self, cosmo, k, a, prof):
        """∫ n(M) u(k, M) dM + counter term."""
        nM, _, mf0, _ = self._weights(cosmo, a)
        uk = self._fourier(cosmo, k, a, prof)               # (M, k)
        integ = torch.trapezoid(nM[:, None] * uk, self._lmass, dim=0)
        return integ + mf0 * uk[0]

    def I_1_1(self, cosmo, k, a, prof):
        """∫ n(M) b(M) u(k, M) dM + counter term."""
        nM, bf, _, mbf0 = self._weights(cosmo, a)
        uk = self._fourier(cosmo, k, a, prof)
        integ = torch.trapezoid((nM * bf)[:, None] * uk, self._lmass, dim=0)
        return integ + mbf0 * uk[0]


def halomodel_power(cosmo, k, a, prof, hmc):
    """Halo-model P(k) = P_2h + P_1h (normalized 2-halo with linear P), a
    float64 tensor on the calculator's device."""
    k = torch.atleast_1d(torch.as_tensor(np.asarray(k, dtype=np.float64),
                                         device=hmc.device))
    pk_lin = _power.linear_power(cosmo, k, a)
    rho0 = _rho_m0(cosmo)
    i11 = hmc.I_1_1(cosmo, k, a, prof) / rho0
    nM, _, mf0, _ = hmc._weights(cosmo, a)
    uk = hmc._fourier(cosmo, k, a, prof)
    i02 = (torch.trapezoid(nM[:, None] * uk ** 2, hmc._lmass, dim=0)
           / rho0 ** 2)
    return pk_lin * i11 ** 2 + i02
