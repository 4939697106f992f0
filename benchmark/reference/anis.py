"""The anisotropic shell paint by the upstream runner's disc scatter path
(reference HealpixRunner.py:487-640): the Mtot canvas painted per pixel
(each pixel's integral), the uniform background the halos leave of the
mean matter density, each halo's model profile weighted on its disc by the
tracer's share of the canvas times the input map, then the background's
tracer term.

Written for the benchmark in plain PyTorch after the port's plain versions
(``disc_paint_anis_plain``, ``anis_finish_plain`` of
``baryonforge_torch/ops/paint.py`` and the runner's background) at the
commit that added the configuration ``anis_paint``: it imports nothing of
the program, and walks each disc whole (``paint.disc_paint_plain``'s
windows), not the program's tiles. A member pixel's distance is the chord
to the halo's centre times D_A / a, as in the disc paint.
"""

import torch

from . import cosmo_core
from . import healpix as hpx
from .deposit import _chunks
from .paint import HALO_COLUMNS, _CHUNK_PIXELS, _log_lookup, disc_paint_plain

__all__ = ["no_tf32", "background", "halo_sum_plain", "anis_paint_plain"]


def no_tf32():
    """float32 matrix products and convolutions in float32 on the card,
    not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def background(cosmo, nside, canvas, redshift, proj_cutoff):
    """(add, rho_halos / rho_m): the uniform background's mass a pixel, dV
    (rho_m - rho_halos) clipped at 0, in a pixel's slice dV of the shell
    from D_A at ``redshift`` to 2 ``proj_cutoff`` beyond it; rho_halos is
    the canvas's mass over the shell's volume."""
    npix, pixarea = hpx.npix(nside), hpx.nside2pixarea(nside)
    a = 1.0 / (1.0 + redshift)
    dL = 2.0 * proj_cutoff
    dD = float(cosmo_core.angular_diameter_distance(cosmo, a)[0])
    rho_m = float(cosmo_core.rho_x(cosmo, a, "matter", is_comoving=False))
    dV = pixarea * ((dD + dL) ** 3 - dD ** 3)
    rho_halos = float(canvas.double().sum()) / (dV * npix)
    return dV * max(rho_m - rho_halos, 0.0), rho_halos / rho_m


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def halo_sum_plain(nside, halos, painting, tracer, mt, orig):
    """sum over halos, on each disc's members, of the model's profile times
    the tracer's over ``mt`` (the canvas with the background), times
    ``orig``. ``painting``, ``tracer``: (log curves of Sigma a, ln_r0,
    dlnr); the geometry and lookups in the curves' dtype, the weights and
    the sum in ``mt``'s."""
    curves_p, ln_r0_p, dlnr_p = painting
    curves_t, ln_r0_t, dlnr_t = tracer
    dt, acc_dt, dev = curves_p.dtype, mt.dtype, curves_p.device
    acc = torch.zeros(hpx.npix(nside), dtype=acc_dt, device=dev)
    og = orig.to(acc_dt)
    for idx_np, K_ring, K_phi in _chunks(nside,
                                         halos["theta"].cpu().numpy(),
                                         halos["radius"].cpu().numpy(),
                                         _CHUNK_PIXELS):
        idx = torch.as_tensor(idx_np, device=dev)
        th, ph, rad, D, a = (halos[k][idx] for k in HALO_COLUMNS)
        pix, _, _, _, sinhd, mask = hpx.disc_candidates(
            nside, th, ph, rad, K_ring, K_phi, dt)
        a_t = a.to(dt)[:, None]
        r_com = 2.0 * sinhd * D.to(dt)[:, None] / a_t
        vp = _finite(_log_lookup(curves_p[idx], ln_r0_p, dlnr_p, r_com)
                     / a_t).to(acc_dt)
        vt = _finite(_log_lookup(curves_t[idx], ln_r0_t, dlnr_t, r_com)
                     / a_t).to(acc_dt)
        pl = pix.long()
        m = mt[pl]
        val = vp * torch.where(m > 0, vt / m, torch.zeros_like(vt)) * og[pl]
        acc.index_add_(0, pl[mask], val[mask])
    return acc


def anis_paint_plain(nside, halos, painting, tracer, mtot, orig, cosmo,
                     redshift, proj_cutoff, bgw, acc_dtype):
    """The painted map (``acc_dtype``; float64 for the reference): the
    canvas of the Mtot curves ``mtot`` (each pixel's integral, summed in
    ``acc_dtype``), ``add`` = :func:`background`, mt = canvas + add, then
    :func:`halo_sum_plain` + bgw add / mt orig (``bgw``: the background
    value times the global tracer fraction). Returns (map, rho_halos /
    rho_m)."""
    canvas = disc_paint_plain(nside, halos, *mtot, True, True, acc_dtype)
    add, share = background(cosmo, nside, canvas, redshift, proj_cutoff)
    mt = canvas + add
    og = orig.to(acc_dtype)
    bg = torch.where(mt > 0, add / mt, torch.zeros_like(mt)) * og
    out = halo_sum_plain(nside, halos, painting, tracer, mt, orig) + bgw * bg
    return out, share
