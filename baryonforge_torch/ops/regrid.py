"""Scatter phase B: regrid the map onto the displaced pixel positions.

``regrid`` is the wrapper of kernel K3 (``csrc/regrid.cu``);
``regrid_plain`` is its plain version, a port of the JAX runner's
``_phase_b`` with ``_weights_for`` / ``_weights_chunk``
(baryonforge_tpu/Runners/HealpixRunner.py:1345-1458). The JAX runner's
sparse form ``_phase_b_sparse`` and its dispatcher ``_regrid`` equal the
dense form up to summation order, so they have no separate port.

K3 takes each ring's colatitude, phi step and sin from a per-ring table
that its first launch fills at the head of its scratch;
``ring_table_plain`` is the plain version of that table.
"""

import ctypes
import math

import torch

from . import _build
from . import healpix as hpx

__all__ = ["regrid", "regrid_plain", "displaced_weights", "ring_table_plain"]

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


def ring_table_plain(nside, dtype, device="cpu"):
    """Plain version of K3's ring table: (theta, dphi, sin_safe) of rings
    1 .. 4 nside - 1 at index i - 1, each in ``dtype``: ring_theta, the
    phi step 2 pi / nr in float64 rounded once, and sin(theta), 1 where it
    is not above 1e-12 (as :func:`displaced_weights` clamps it)."""
    r = torch.arange(1, 4 * nside, dtype=torch.int32, device=device)
    _, nr, _, _ = hpx.ring_info(nside, r, dtype)
    theta = hpx.ring_theta(nside, r, dtype)
    # a true division (a Python number over a tensor is a reciprocal times
    # the number in torch), as the kernel's ring_dphi
    dphi = (torch.full_like(nr, 2 * math.pi, dtype=torch.float64)
            / nr.double()).to(dtype)
    sin_t = torch.sin(theta)
    sin_safe = torch.where(sin_t > 1e-12, sin_t, torch.ones_like(sin_t))
    return theta, dphi, sin_safe


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
    # the kernel reads 4 pixels' offsets and values by 16-byte accesses
    if po.data_ptr() % 16:
        po = po.clone()
    if orig.data_ptr() % 16:
        orig = orig.clone()
    out = torch.empty(npx, dtype=orig.dtype, device=dev)
    _launch(nside, po, orig, _scratch(nside, orig.dtype, dev), out)
    return out


def _launch(nside, po, orig, scratch, out):
    """K3 on checked arguments (contiguous, 16-byte aligned, on one card)
    with its scratch (:func:`_scratch`), whose head holds the ring table
    after the call."""
    fn = getattr(_build.library(), "bf_regrid_{}_{}".format(
        _sfx(po.dtype), _sfx(orig.dtype)))
    with torch.cuda.device(out.device):
        err = fn(nside, _build.ptr(po), _build.ptr(orig), _build.ptr(scratch),
                 _build.ptr(out), _build.stream_of(out))
    _build.check(err, "regrid")
    _build.launches["regrid"] += 1


def _sfx(dt):
    return "f32" if dt == torch.float32 else "f64"


def _scratch(nside, dtype, dev):
    """K3's scratch, uninitialised (its first launch fills it): the ring
    table (4 nside rows of theta, phi step, sin and a pad, each in
    ``dtype``; row i for ring i), then the tiles' counts and lists of
    moved pixels (4 bytes a pixel)."""
    n = ctypes.c_longlong()
    _build.library().bf_regrid_scratch_bytes(
        nside, int(dtype == torch.float64), ctypes.addressof(n))
    return torch.empty(n.value, dtype=torch.uint8, device=dev)
