"""Scatter phase B: every pixel moved by its offset and shared among the 4
interpolation neighbours of its new position (the plain version of
kernel K3).

A frozen copy of the plain (CPU) version in ``baryonforge_torch/ops/regrid.py`` at
the commit that added the benchmark, with the kernel wrappers left out, so
that it runs in plain PyTorch on any device. It is the benchmark's
reference: it imports nothing of the program and is not edited with it.
"""

import math

import torch

from . import healpix as hpx


# sources per step of the plain version (~30 temporaries of this length)
_CHUNK = 1 << 22


def displaced_weights(nside, dtype, self_pix, po, theta_p, phi_p):
    """Displaced 4-neighbour (pixels, weights) of sources ``self_pix`` at
    pixel centres (theta_p, phi_p) moved by tangent offsets ``po`` (n, 2):
    pole overshoots are reflected (phi turns by pi), and a source with a
    zero offset maps to itself with weight exactly 1."""
    sin_t = torch.sin(theta_p)
    sin_safe = torch.where(sin_t > 1e-12, sin_t, torch.ones_like(sin_t))
    theta = theta_p + po[:, 0].to(dtype)
    phi = phi_p + po[:, 1].to(dtype) / sin_safe
    over = (theta < 0) | (theta > math.pi)
    theta = torch.abs(theta)
    theta = torch.where(theta > math.pi, 2 * math.pi - theta, theta)
    phi = torch.where(over, phi + math.pi, phi)
    cpix, cw = hpx.get_interp_weights(nside, theta, phi, dtype)
    unmoved = ((po[:, 0] == 0) & (po[:, 1] == 0))[:, None]
    first = torch.arange(4, device=po.device) == 0
    cpix = torch.where(unmoved, torch.where(first, self_pix[:, None], 0),
                       cpix)
    cw = torch.where(unmoved, first.to(dtype), cw)
    return cpix, cw


def regrid_plain(nside, pix_offsets, orig):
    """Plain version of K3, in source chunks. Arguments as
    :func:`regrid`."""
    dt = orig.dtype
    npx = hpx.npix(nside)
    out = torch.zeros(npx, dtype=dt, device=orig.device)
    for start in range(0, npx, _CHUNK):
        stop = min(start + _CHUNK, npx)
        p = torch.arange(start, stop, dtype=torch.int32, device=orig.device)
        theta_p, phi_p = hpx.pix2ang(nside, p, dt)
        cpix, cw = displaced_weights(nside, dt, p, pix_offsets[start:stop],
                                     theta_p, phi_p)
        contrib = cw * orig[start:stop, None]
        out.index_add_(0, cpix.reshape(-1).long(), contrib.reshape(-1))
    return out
