"""Utility profiles (port of ``baryonforge_tpu.Profiles.misc``): the
truncation window, identity and zero test doubles, a Fourier transform with
per-halo limits and unit-conversion wrappers, plain torch in float64."""

import math

import torch

from .Base import (Profile, _atleast_1d_pair, _halo_radius,
                   _host_halo_radius, _ndim, _rows, eval_rows, resolve_device)
from ..ops.grids import jnp_geomspace, jnp_linspace
from ..ops.integrate import trapz

__all__ = ["Truncation", "Identity", "Zeros", "TruncatedFourier",
           "ComovingToPhysical", "Mdelta_to_Mtot"]


def _full(M_use, r_use, value):
    return torch.full((M_use.numel(), r_use.shape[-1]), value,
                      dtype=torch.float64, device=M_use.device)


class Truncation(Profile):
    """Indicator profile: 1 inside epsilon * R_def, 0 outside. Multiply onto
    another profile to truncate it (reference misc.py:11-83)."""

    model_param_names = ["epsilon_trunc"]
    per_halo_r = True

    def __init__(self, epsilon_trunc=1.0, **kwargs):
        super().__init__(**kwargs)
        self.epsilon_trunc = epsilon_trunc

    def _real(self, cosmo, r_use, M_use, a):
        R = _host_halo_radius(self, cosmo, M_use, a)
        return (_rows(r_use) < self.epsilon_trunc * R[:, None]).to(
            torch.float64)


class Identity(Profile):
    """Profile that is 1 everywhere (test double, reference misc.py:86)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        return _full(M_use, r_use, 1.0)


class Zeros(Profile):
    """Profile that is 0 everywhere, for nulling components (reference
    misc.py:120-160)."""

    per_halo_r = True

    def _real(self, cosmo, r_use, M_use, a):
        return _full(M_use, r_use, 0.0)

    def _fourier(self, cosmo, k_use, M_use, a):
        return _full(M_use, k_use, 0.0)

    def _projected(self, cosmo, r, M, a, **kw):
        r_use, M_use = _atleast_1d_pair(r, M, resolve_device(r, M))
        return _full(M_use, r_use, 0.0)


class TruncatedFourier(Profile):
    """Fourier transform with hard per-halo integration limits
    [eps_min R, eps_max R] for sharply truncated profiles (reference
    misc.py:164-228). Wraps another profile."""

    def __init__(self, profile, epsilon_max=1.0, epsilon_min=1e-3, N_int=512,
                 **kwargs):
        self.Profile = profile
        self.epsilon_max = epsilon_max
        self.epsilon_min = epsilon_min
        self.N_int = N_int
        self.model_param_names = profile.model_param_names
        super().__init__(**{**profile.model_params, **profile.hyper_params})

    @property
    def per_halo_r(self):
        return self.Profile.per_halo_r

    def _real(self, cosmo, r_use, M_use, a):
        return self.Profile._real(cosmo, r_use, M_use, a)

    def _fourier(self, cosmo, k_use, M_use, a):
        R = _halo_radius(self, cosmo, M_use, a)
        # a log grid from eps_min R to eps_max R a halo and a direct
        # quadrature of 4 pi r^2 rho j0(kr) on it (the limits are per halo,
        # so no FFTLog)
        t = torch.as_tensor(jnp_linspace(0.0, 1.0, self.N_int),
                            device=M_use.device)
        r_lo = self.epsilon_min * R
        r_hi = self.epsilon_max * R
        r_int = torch.exp(torch.log(r_lo)[:, None]
                          + (torch.log(r_hi) - torch.log(r_lo))[:, None]
                          * t[None])
        rho = eval_rows(self.Profile, cosmo, r_int, M_use, a)
        x = k_use[None, None, :] * r_int[:, :, None]
        j0 = torch.sinc(x / math.pi)
        integrand = (4 * math.pi * r_int[:, :, None] ** 2 * rho[:, :, None]
                     * j0)
        return trapz(integrand, r_int[:, :, None], axis=1)


class ComovingToPhysical(Profile):
    """Wraps profile * a^factor (projected gains one more power of a)
    (reference misc.py:231-276)."""

    def __init__(self, profile, factor=1.0, **kwargs):
        self.Profile = profile
        self.factor = factor
        self.model_param_names = profile.model_param_names
        super().__init__(**{**profile.model_params, **profile.hyper_params})

    @property
    def per_halo_r(self):
        return self.Profile.per_halo_r

    def _real(self, cosmo, r_use, M_use, a):
        return self.Profile._real(cosmo, r_use, M_use, a) * a ** self.factor

    def _projected(self, cosmo, r, M, a, **kw):
        return (self.Profile._projected(cosmo, r, M, a, **kw)
                * a ** (self.factor + 1))


class Mdelta_to_Mtot:
    """M_tot(M_delta) by integrating rho out to r_max (reference
    misc.py:279-325), on the device of M when it is a tensor, else CUDA."""

    def __init__(self, profile, r_min=1e-6, r_max=100.0, N_int=512):
        self.Profile = profile
        self.r_min = r_min
        self.r_max = r_max
        self.N_int = N_int

    def __call__(self, cosmo, M, a):
        dev = resolve_device(M)
        M_use = torch.atleast_1d(torch.as_tensor(M, dtype=torch.float64,
                                                 device=dev))
        r_int = torch.as_tensor(jnp_geomspace(self.r_min, self.r_max,
                                              self.N_int), device=dev)
        rho = self.Profile._real(cosmo, r_int, M_use, a)
        Mtot = trapz(4 * math.pi * r_int ** 2 * rho, r_int)
        return Mtot[0] if _ndim(M) == 0 else Mtot
