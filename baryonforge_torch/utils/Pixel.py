"""Pixel-window convolution of profiles (port of
``baryonforge_tpu.utils.Pixel``).

``ConvolvedProfile`` wraps a profile and convolves it with an isotropic
pixel window by an FFTLog round trip on the natural reciprocal grids
(``ops.fftlog.convolve_profile``: the transform is kernel K8 on CUDA), one
transform per row of the (M, r) profile. Below pixel_size/5 the output is
clamped against small-scale ringing (reference Pixel.py:169).

Windows (each maps a wavenumber tensor k to W(k)):
  * GridPixelApprox: square pixel as a circular top hat, 3 j1(x)/x with the
    volume- or area-equivalent radius (reference Pixel.py:272-450)
  * HealPixel: HEALPix pixel as a Gaussian harmonic beam
    exp(-k(k+1) sigma^2/2), sigma = resol/sqrt(8 ln2)/sqrt(2); its real-space
    window is zeros on purpose (reference Pixel.py:454-583)
  * NoPix: unity window (reference Pixel.py:586-625)
"""

import numpy as np
import torch

from ..cosmo import core as _core
from ..ops import fftlog as _fftlog
from ..ops import healpix as _hpx
from ..ops.interp import pchip_interp
from ..Profiles.Base import resolve_device, _ndim
from .Tabulate import _set_parameter

__all__ = ["ConvolvedProfile", "GridPixelApprox", "HealPixel", "NoPix"]


class GridPixelApprox:
    """Square grid pixel approximated as a circular top hat."""

    isHarmonic = False

    def __init__(self, size):
        self.size = size

    def beam(self, k, R):
        # 3 j1(x)/x with x = k * 2R (diameter convention, ref. Pixel.py)
        x = k * (2.0 * R)
        x_safe = torch.where(x > 0, x, torch.ones_like(x))
        j1_over = (torch.sin(x_safe) / x_safe ** 2
                   - torch.cos(x_safe) / x_safe)   # spherical j1(x)
        return torch.where(x > 0, 3.0 * j1_over / x_safe,
                           torch.ones_like(x))

    def real(self, k):
        R = np.cbrt(self.size ** 3 / (4.0 / 3.0 * np.pi))
        return self.beam(k, R)

    def projected(self, k):
        R = np.sqrt(self.size ** 2 / np.pi)
        return self.beam(k, R)


class HealPixel:
    """HEALPix pixel as a Gaussian harmonic beam. ``real`` returns zeros on
    purpose: real-space use of an angular pixel is meaningless, and zeros
    show it (reference behaviour)."""

    isHarmonic = True

    def __init__(self, NSIDE):
        self.NSIDE = NSIDE
        self.size = float(np.sqrt(_hpx.nside2pixarea(NSIDE)))

    def real(self, k):
        return torch.zeros_like(k)

    def projected(self, k):
        sig = self.size / np.sqrt(8 * np.log(2)) / np.sqrt(2)
        return torch.exp(-k * (1 + k) / 2 * sig ** 2)


class NoPix:
    """Unity window (testing)."""

    isHarmonic = False
    size = 0.0

    def real(self, k):
        return torch.ones_like(k)

    def projected(self, k):
        return torch.ones_like(k)


class ConvolvedProfile:
    """profile (*) pixel window, a drop-in profile wrapper (reference
    Pixel.py:12-267). Unknown attributes delegate to the wrapped profile.
    Runs on the device of a tensor ``r`` (or ``M``), else on CUDA, as the
    profiles do."""

    def __init__(self, Profile, Pixel):
        self.Profile = Profile
        self.Pixel = Pixel
        self.isHarmonic = Pixel.isHarmonic
        self.p_keys = list(vars(Profile).get("p_keys", []))

    def __getattr__(self, name):
        try:
            return super().__getattribute__(name)
        except AttributeError:
            return getattr(self.Profile, name)

    def __getstate__(self):
        return self.__dict__.copy()

    def __setstate__(self, state):
        self.__dict__.update(state)

    def set_parameter(self, key, value):
        _set_parameter(self, key, value)

    def __str_prf__(self):
        return (f"Convolution[{self.Profile.__str_prf__()}, "
                f"{self.Pixel.__class__.__name__}]")

    def __repr__(self):
        return self.__str_prf__()

    # ------------------------------------------------------------------
    def _fft_grid(self, r):
        """The FFTLog grid (host numpy) and bias, from r's host values; the
        decade count is truncated to an integer as the JAX package does."""
        p = getattr(self.Profile, "precision_fftlog",
                    dict(padding_lo_fftlog=1e-2, padding_hi_fftlog=1e2,
                         n_per_decade=64, plaw_fourier=-2.0))
        if isinstance(r, torch.Tensor):
            r = r.detach().cpu().numpy()
        r = np.atleast_1d(np.asarray(r, dtype=float))
        r_min = min(float(r.min()) * p["padding_lo_fftlog"], 1e-8)
        r_max = max(float(r.max()) * p["padding_hi_fftlog"], 1e3)
        n = int(p["n_per_decade"] * np.int32(np.log10(r_max / r_min)))
        n = int(2 ** np.ceil(np.log2(max(n, 64))))
        return np.geomspace(r_min, r_max, n), p["plaw_fourier"]

    def _convolved(self, method, window, dim, r, M, a, scale, clip_lo,
                   cosmo, **kw):
        """The wrapped profile's ``method`` on the FFTLog grid, convolved
        row by row with ``window`` in ``dim`` dimensions with the radii
        divided by ``scale``, and read at r (clamped below at ``clip_lo``)
        by PCHIP without extrapolation; NaN reads as 0."""
        dev = resolve_device(r, M)
        r_fft, plaw = self._fft_grid(r)
        r_fft_t = torch.as_tensor(r_fft, device=dev)
        prof = getattr(self.Profile, method)(cosmo, r_fft_t, M, a, **kw)
        prof = prof.reshape(-1, r_fft.size)
        x_j = r_fft_t / scale
        conv = _fftlog.convolve_profile(x_j, prof, window, dim=dim,
                                        plaw=plaw)
        r_t = torch.atleast_1d(torch.as_tensor(r, dtype=torch.float64,
                                               device=dev))
        x_eval = torch.clamp(r_t, min=clip_lo) / scale
        out = pchip_interp(torch.log(x_j), conv, torch.log(x_eval),
                           extrapolate=False)
        out = torch.where(torch.isnan(out), torch.zeros_like(out), out)
        if _ndim(r) == 0:
            out = out.squeeze(-1)
        if _ndim(M) == 0:
            out = out.squeeze(0)
        return out

    def real(self, cosmo, r, M, a, **kw):
        return self._convolved("real", self.Pixel.real, 3, r, M, a, 1.0,
                               self.Pixel.size / 5, cosmo, **kw)

    def projected(self, cosmo, r, M, a, **kw):
        # an angular pixel works in angle theta = r / D, with D the
        # comoving radial distance, as the JAX package divides
        D = (float(_core.comoving_radial_distance(cosmo, a)[0])
             if self.isHarmonic else 1.0)
        return self._convolved("projected", self.Pixel.projected, 2, r, M,
                               a, D, self.Pixel.size / 5 * D, cosmo, **kw)

    def fourier(self, cosmo, k, M, a, **kw):
        F = self.Profile.fourier(cosmo, k, M, a, **kw)
        return F * self.Pixel.real(torch.as_tensor(k, dtype=torch.float64,
                                                   device=F.device))
