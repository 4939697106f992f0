"""Scatter phase B: regrid the map onto the displaced pixel positions.

``regrid`` is the wrapper of kernel K3 (``csrc/regrid.cu``);
``regrid_plain`` is its plain version, a port of the JAX runner's
``_phase_b`` with ``_weights_for`` / ``_weights_chunk``
(baryonforge_tpu/Runners/HealpixRunner.py:1345-1458). The JAX runner's
sparse form ``_phase_b_sparse`` and its dispatcher ``_regrid`` equal the
dense form up to summation order, so they have no separate port.
"""

import math

import torch

from . import _build
from . import healpix as hpx

__all__ = ["regrid", "regrid_plain", "displaced_weights"]

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


def regrid(nside, pix_offsets, orig):
    """Move every pixel of ``orig`` by its tangent offset and share its
    value among the 4 interpolation neighbours of its new position.

    nside       : HEALPix NSIDE (<= 8192)
    pix_offsets : (npix, 2) float32 or float64 (d theta, sin theta d phi)
    orig        : (npix,) map in the regrid dtype (float32 or float64),
                  which is also the dtype of the weights and of the result

    Returns the regridded (npix,) map. Kernel K3 for tensors on CUDA, the
    plain version for tensors on the CPU.
    """
    if not 1 <= nside <= hpx.MAX_NSIDE:
        raise ValueError(f"regrid: NSIDE {nside} outside "
                         f"[1, {hpx.MAX_NSIDE}] (int32 pixel math)")
    npx = hpx.npix(nside)
    fdt = (torch.float32, torch.float64)
    if pix_offsets.dtype not in fdt or orig.dtype not in fdt:
        raise TypeError("regrid: offsets and map must be float32 or float64")
    if pix_offsets.shape != (npx, 2) or orig.shape != (npx,):
        raise ValueError(f"regrid: need offsets ({npx}, 2) and map "
                         f"({npx},) at NSIDE {nside}")
    if pix_offsets.device != orig.device:
        raise ValueError("regrid: offsets and map on different devices")
    dev = orig.device
    if dev.type == "cpu":
        return regrid_plain(nside, pix_offsets, orig)
    if dev.type != "cuda":
        raise ValueError(f"regrid: unsupported device {dev}")
    po = pix_offsets.contiguous()
    orig = orig.contiguous()
    out = torch.zeros(npx, dtype=orig.dtype, device=dev)
    name = "bf_regrid_{}_{}".format(
        *("f32" if t == torch.float32 else "f64"
          for t in (po.dtype, orig.dtype)))
    fn = getattr(_build.library(), name)
    with torch.cuda.device(dev):
        err = fn(nside, _build.ptr(po), _build.ptr(orig), _build.ptr(out),
                 _build.stream_of(out))
    _build.check(err, "regrid")
    _build.launches["regrid"] += 1
    return out
