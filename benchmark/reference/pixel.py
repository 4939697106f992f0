"""Pixel-window convolution of profiles: the HEALPix pixel as a Gaussian
harmonic beam, applied by an FFTLog round trip (``fftlog.convolve_profile``).
The convolution runs in ``ConvolvedProfile.dtype`` (float64 unless a
control asks for less).

A frozen copy of the plain (CPU) version in ``baryonforge_torch/utils/Pixel.py`` at
the commit that added the benchmark, with the kernel wrappers left out, so
that it runs in plain PyTorch on any device. It is the benchmark's
reference: it imports nothing of the program and is not edited with it.
"""

import numpy as np
import torch

from . import cosmo_core as _core
from . import fftlog as _fftlog
from . import healpix as _hpx
from .interp import pchip_interp
from .profile_base import resolve_device, _ndim
from .tabulate import _set_parameter


class HealPixel:
    """HEALPix pixel as a Gaussian harmonic beam. ``real`` returns zeros on
    purpose: real-space use of an angular pixel is meaningless, and zeros
    show it (reference behaviour)."""

    isHarmonic = True

    def __init__(self, NSIDE):
        self.NSIDE = NSIDE
        self.size = float(np.sqrt(_hpx.nside2pixarea(NSIDE)))

    def projected(self, k):
        sig = self.size / np.sqrt(8 * np.log(2)) / np.sqrt(2)
        return torch.exp(-k * (1 + k) / 2 * sig ** 2)


class ConvolvedProfile:
    """profile (*) pixel window, a drop-in profile wrapper (reference
    Pixel.py:12-267). Unknown attributes delegate to the wrapped profile.
    Runs on the device of a tensor ``r`` (or ``M``), else on CUDA, as the
    profiles do; the convolution in ``dtype``."""

    dtype = torch.float64

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

    def set_parameter(self, key, value):
        _set_parameter(self, key, value)

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
        conv = _fftlog.convolve_profile(x_j.to(self.dtype),
                                        prof.to(self.dtype), window, dim=dim,
                                        plaw=plaw).double()
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

    def projected(self, cosmo, r, M, a, **kw):
        # an angular pixel works in angle theta = r / D, with D the
        # comoving radial distance, as the JAX package divides
        D = (float(_core.comoving_radial_distance(cosmo, a)[0])
             if self.isHarmonic else 1.0)
        return self._convolved("projected", self.Pixel.projected, 2, r, M,
                               a, D, self.Pixel.size / 5 * D, cosmo, **kw)

