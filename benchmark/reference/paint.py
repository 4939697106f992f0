"""The disc paint: each halo's profile painted on the pixels of its disc
(the plain version of kernel K11).

A frozen copy of the plain (CPU) version in ``baryonforge_torch/ops/paint.py`` at
the commit that added the benchmark, with the kernel wrappers left out, so
that it runs in plain PyTorch on any device. It is the benchmark's
reference: it imports nothing of the program and is not edited with it.
"""

import torch

from . import healpix as hpx
from .deposit import _chunks


HALO_COLUMNS = ("theta", "phi", "radius", "D", "a")


_CHUNK_PIXELS = 1 << 22     # padded window pixels per halo chunk


def _log_lookup(curve, ln_r0, dlnr, r):
    """exp of the log curves' 1-D log-uniform lerp at radii ``r``; zero
    outside the tabulated range (``TabulatedProfile.curve_lookup``)."""
    n_r = curve.shape[-1]
    x = (torch.log(torch.clamp(r, min=1e-30)) - ln_r0) / dlnr
    i = torch.clamp(torch.floor(x).to(torch.int64), 0, n_r - 2)
    t = x - i
    out = torch.exp(torch.gather(curve, -1, i) * (1 - t)
                    + torch.gather(curve, -1, i + 1) * t)
    return torch.where((x < 0) | (x > n_r - 1), torch.zeros_like(out),
                       out)


def _lookup(log_curves):
    if log_curves:
        return _log_lookup
    from .baryon_correction import BaryonificationClass
    return BaryonificationClass.curve_lookup


def disc_paint_plain(nside, halos, curves, ln_r0, dlnr, log_curves,
                     pixel_size, acc_dtype):
    """Plain version of K11: padded disc windows, vectorised over halo
    chunks, summed with ``index_add_``. Arguments as :func:`disc_paint`."""
    dt, dev = curves.dtype, curves.device
    acc = torch.zeros(hpx.npix(nside), dtype=acc_dtype, device=dev)
    if curves.shape[0] == 0:
        return acc
    lookup = _lookup(log_curves)
    pixarea = hpx.nside2pixarea(nside)
    for idx_np, K_ring, K_phi in _chunks(nside,
                                         halos["theta"].cpu().numpy(),
                                         halos["radius"].cpu().numpy(),
                                         _CHUNK_PIXELS):
        idx = torch.as_tensor(idx_np, device=dev)
        th, ph, rad, D, a = (halos[k][idx] for k in HALO_COLUMNS)
        pix, _, _, _, sinhd, mask = hpx.disc_candidates(
            nside, th, ph, rad, K_ring, K_phi, dt)
        chord = 2.0 * sinhd
        a_t = a.to(dt)[:, None]
        r_com = chord * D.to(dt)[:, None] / a_t
        paint = lookup(curves[idx], ln_r0, dlnr, r_com) / a_t
        paint = torch.where(torch.isfinite(paint), paint,
                            torch.zeros_like(paint))
        if pixel_size:
            paint = paint * (pixarea * D ** 2).to(dt)[:, None]
        acc.index_add_(0, pix[mask].long(), paint[mask].to(acc_dtype))
    return acc
