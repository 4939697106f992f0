"""Spherical-harmonic analysis of RING-ordered HEALPix maps.

Port of ``baryonforge_tpu.utils.sht`` (the ``healpy.anafast`` step of the
reference's Delta-Cl workflow), in float64:

  K18  ring modes: each iso-latitude ring's DFT, m <= lmax
       (ops/sht.ring_modes)
  K19  Legendre transform: for each m the normalised associated Legendre
       functions run up in l and contracted with the ring modes over the
       rings (ops/sht.legendre_alm)

then a_lm times the pixel area 4 pi / npix, and C_l = (|a_l0|^2 + 2 sum_{m>0}
|a_lm|^2) / (2l + 1). The functions run on ``device="cuda"`` unless the
caller passes ``device="cpu"`` (the plain versions); the map may be numpy
or a tensor. ``ring_batch`` bounds the JAX version's TPU buffers and has no
effect here.
"""

import math

import numpy as np
import torch

from ..ops.sht import legendre_alm, ring_geometry, ring_modes

__all__ = ["ring_alm_real", "anafast"]

_ring_geometry = ring_geometry


def _device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("utils.sht: device='cuda' but CUDA is not "
                           "available; pass device='cpu' for the plain "
                           "versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def ring_alm_real(nside, hmap, lmax, ring_batch=8, device="cuda"):
    """(Re, Im) of a_lm for m >= 0, float64 tensors (L, L) on ``device``
    indexed [m, l], zero for l < m."""
    dev = _device(device)
    sp, nr, z, phi0 = ring_geometry(nside)
    npix = 12 * nside * nside
    omega = 4.0 * math.pi / npix
    hmap = torch.as_tensor(hmap, dtype=torch.float64).to(dev).reshape(-1)
    Fr, Fi = ring_modes(hmap, nside, lmax)
    alm_r, alm_i = legendre_alm(torch.as_tensor(z, device=dev), Fr, Fi, lmax)
    return alm_r * omega, alm_i * omega


def anafast(hmap, lmax=None, nside=None, ring_batch=8, device="cuda"):
    """Angular power spectrum C_l of a RING map (healpy.anafast analog),
    numpy float64 (lmax + 1,):

    C_l = 1/(2l+1) [ |a_l0|^2 + 2 sum_{m>0} |a_lm|^2 ].
    """
    size = hmap.numel() if isinstance(hmap, torch.Tensor) else np.size(hmap)
    if nside is None:
        nside = int(np.sqrt(size / 12))
    if 12 * nside * nside != size:
        raise ValueError("not a healpix map")
    if lmax is None:
        lmax = 3 * nside - 1
    alm_r, alm_i = ring_alm_real(nside, hmap, lmax, ring_batch=ring_batch,
                                 device=device)
    p = alm_r ** 2 + alm_i ** 2                          # (m, l)
    ell = torch.arange(lmax + 1, dtype=torch.float64, device=p.device)
    m, l = ell[:, None], ell[None, :]
    w = (1.0 + (m > 0).to(torch.float64)) * (m <= l)
    cl = torch.sum(p * w, dim=0) / (2.0 * ell + 1.0)
    return cl.cpu().numpy()
