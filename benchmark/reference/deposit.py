"""Scatter phase A: the per-halo disc deposit of tangent-angle offsets
(the plain version of kernel K2).

A frozen copy of the plain (CPU) version in ``baryonforge_torch/ops/deposit.py`` at
the commit that added the benchmark, with the kernel wrappers left out, so
that it runs in plain PyTorch on any device. It is the benchmark's
reference: it imports nothing of the program and is not edited with it.
"""

import numpy as np
import torch

from . import healpix as hpx
from .baryon_correction import BaryonificationClass


_HALO_COLUMNS = ("theta", "phi", "radius", "D", "a", "Rcom", "rscale")


# colatitude classes of _prepare_groups: a disc whose band keeps
# sin(theta) >= s gets the phi window of disc_pad_sizes(..., sin_min=s)
_SIN_CLASSES = (0.25, 0.05, 0.0)


def _chunks(nside, theta, radius, budget):
    """Halo index chunks with their padded (K_ring, K_phi) windows: halos
    grouped by colatitude class, sorted by radius, cut so that a chunk's
    padded pixel count stays within ``budget``."""
    lo = np.minimum(np.sin(theta - radius), np.sin(theta + radius))
    pole = (theta - radius < 0) | (theta + radius > np.pi)
    smin = np.where(pole, 0.0, np.maximum(lo, 0.0))
    cls = np.select([smin >= _SIN_CLASSES[0], smin >= _SIN_CLASSES[1]],
                    [0, 1], 2)
    out = []
    for c, s_band in enumerate(_SIN_CLASSES):
        idx = np.where(cls == c)[0]
        idx = idx[np.argsort(radius[idx], kind="stable")]
        start = 0
        while start < idx.size:
            def window(stop):
                return hpx.disc_pad_sizes(nside, float(radius[idx[stop - 1]]),
                                          s_band)

            def fits(stop):
                kr, kp = window(stop)
                return (stop - start) * kr * kp <= budget

            stop = start + 1
            step = 1
            while stop + step <= idx.size and fits(stop + step):
                stop += step
                step *= 2
            while step > 1:
                step //= 2
                if stop + step <= idx.size and fits(stop + step):
                    stop += step
            out.append((idx[start:stop], *window(stop)))
            start = stop
    return out


def _windows(nside, halos, dt, pixel_budget):
    """Per chunk of halos (``_chunks``): their ids and the padded disc
    query of ``hpx.disc_candidates`` in ``dt``."""
    dev = halos["theta"].device
    for idx_np, K_ring, K_phi in _chunks(nside,
                                         halos["theta"].cpu().numpy(),
                                         halos["radius"].cpu().numpy(),
                                         pixel_budget):
        idx = torch.as_tensor(idx_np, device=dev)
        yield idx, hpx.disc_candidates(nside, halos["theta"][idx],
                                       halos["phi"][idx],
                                       halos["radius"][idx], K_ring, K_phi,
                                       dt)


def disc_deposit_plain(nside, halos, curves, ln_r0, dlnr, eps_max,
                       pixel_budget=1 << 22):
    """Plain version of K2: padded disc windows, vectorised over halo
    chunks, summed with ``index_add_``. Arguments as :func:`disc_deposit`.

    Precision mirrors one_halo under x64: the geometry is in the curves'
    dtype, except the halo's own cos/sin(theta), the fallback's phi offset
    and the fallback haversine's first term, which the JAX code computes
    from the float64 halo columns before rounding."""
    dt = curves.dtype
    dev = curves.device
    acc = torch.zeros((hpx.npix(nside), 2), dtype=dt, device=dev)
    n = curves.shape[0]
    if n == 0:
        return acc
    for idx, (pix, cos_t, sin_t, dphi_pix, sinhd, mask) in _windows(
            nside, halos, dt, pixel_budget):
        th, ph, rad, D, a, Rcom, rscale = (halos[k][idx]
                                           for k in _HALO_COLUMNS)
        # fewer than 4 disc pixels -> the 4 interpolation neighbours
        # (reference HealpixRunner.py:332-334)
        use4 = (mask.sum(dim=1) < 4)[:, None]
        pix4, _ = hpx.get_interp_weights(nside, th, ph, dt)
        t4, p4 = hpx.pix2ang(nside, pix4, dt)
        st0 = torch.sin(th).to(dt)[:, None]
        ct0 = torch.cos(th).to(dt)[:, None]
        dphi4 = (p4.double() - ph[:, None]).to(dt)
        sdp4 = torch.sin(0.5 * dphi4)
        sdt4 = torch.sin(0.5 * (t4.double() - th[:, None]))
        hav4 = sdt4 * sdt4 + (torch.sin(t4) * st0 * (sdp4 * sdp4)).double()
        pix = torch.cat([pix, pix4], dim=1)
        mask = torch.cat([mask & ~use4, use4.expand(-1, 4)], dim=1)
        cos_t = torch.cat([cos_t, torch.cos(t4)], dim=1)
        sin_t = torch.cat([sin_t, torch.sin(t4)], dim=1)
        dphi_pix = torch.cat([dphi_pix, dphi4], dim=1)
        sinhd = torch.cat(
            [sinhd, torch.sqrt(torch.clamp(hav4, 0.0, 1.0)).to(dt)], dim=1)

        # chord on the unit sphere -> comoving separation -> curve lookup
        chord = 2.0 * sinhd
        D_t = D.to(dt)[:, None]
        a_t = a.to(dt)[:, None]
        r_com = chord * D_t / a_t
        r_safe = torch.where(r_com > 0, r_com, torch.full_like(r_com, 1e-30))
        d = BaryonificationClass.curve_lookup(
            curves[idx], ln_r0, dlnr, r_safe * rscale.to(dt)[:, None])
        d = torch.where(r_com < float(eps_max) * Rcom.to(dt)[:, None], d,
                        torch.zeros_like(d)) * a_t
        d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))

        # tangent components of (d/D) (vec - vec_h)/chord at the pixel
        chord_safe = torch.where(chord > 0, chord, torch.ones_like(chord))
        amp = d / (D_t * chord_safe)
        t_th = amp * (ct0 * sin_t - st0 * cos_t * torch.cos(dphi_pix))
        t_ph = amp * (st0 * torch.sin(dphi_pix))
        delta = torch.stack([t_th, t_ph], dim=-1)
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        acc.index_add_(0, pix[mask].long(), delta[mask])
    return acc
