"""The scatter paint: each halo's profile painted on the pixels of its disc.

``disc_paint`` is the wrapper of kernel K11 (``csrc/disc_paint.cu``);
``disc_paint_plain`` is its plain version, a port of the JAX runner's
``PaintProfilesShell._paint_device`` body (``make_body`` / ``one_halo`` /
``body``, baryonforge_tpu/Runners/HealpixRunner.py:1948-1989) over the
padded disc windows of ``ops.deposit``. Per member pixel, in the curves'
dtype: r_com = chord D / a, the curve lookup (log curves exp'd), / a, zero
if not finite, times pixarea D^2 for the per-pixel integral; summed into an
(npix,) map of the accumulator's dtype. There is no small-disc fallback
and no eps_max cut: the disc is the only cut.
"""

import torch

from . import _build
from . import healpix as hpx
from .deposit import _chunks

__all__ = ["disc_paint", "disc_paint_plain", "float32_tolerance",
           "HALO_COLUMNS"]

HALO_COLUMNS = ("theta", "phi", "radius", "D", "a")

# Two float32 evaluations of the paint whose transcendental functions differ
# in their last bits (the device's acosf against torch's) put a ring's
# colatitude theta_r in [0, pi] up to 4 ulps (4 x 2^-22) apart, where each
# is within 2; the haversine's sin((theta_r - theta0) / 2), and with it
# sin(d/2), then moves by up to 2^-21, absolute.
SINHD_REACH = 2.0 ** -21

_CHUNK_PIXELS = 1 << 22     # padded window pixels per halo chunk


def _lookup(log_curves):
    if log_curves:
        from ..utils.Tabulate import TabulatedProfile
        return TabulatedProfile.curve_lookup
    from ..Profiles.BaryonCorrection import BaryonificationClass
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


def float32_tolerance(nside, halos, curves, ln_r0, dlnr, log_curves):
    """How far two float32 paints (K10 or K11 against a plain version) may
    differ per pixel when only the last bits of their transcendental
    functions do. Arguments as :func:`disc_paint`; curves of one sign.

    Near a halo's centre the float32 geometry is ill-conditioned: r moves
    by SINHD_REACH / sin(d/2) relative, and the painted value by S times
    that, S the largest |d ln v / d ln r| of the halo's curve. A pixel's
    relative tolerance is 1e-4 (rounding of the curve, lerp, exp and sums)
    plus the largest such term of the halos painting it. A pixel is
    marginal where one of its (halo, pixel) pairs sits within that reach of
    the disc's edge or the table's ends, so float32 may keep or drop it.

    Computed in float64 on the curves' device. Returns the (npix,) relative
    tolerances and the (npix,) marginal mask.
    """
    dev = curves.device
    npix = hpx.npix(nside)
    rtol = torch.zeros(npix, dtype=torch.float64, device=dev)
    marginal = torch.zeros(npix, dtype=torch.bool, device=dev)
    n_r = curves.shape[1]
    lc = curves.double() if log_curves else torch.log(curves.double().abs())
    slope = torch.nan_to_num((lc[:, 1:] - lc[:, :-1]).abs() / dlnr, nan=0.0,
                             posinf=0.0).amax(1)
    for idx_np, K_ring, K_phi in _chunks(nside,
                                         halos["theta"].cpu().numpy(),
                                         halos["radius"].cpu().numpy(),
                                         _CHUNK_PIXELS):
        idx = torch.as_tensor(idx_np, device=dev)
        th, ph, rad, D, a = (halos[k][idx] for k in HALO_COLUMNS)
        pix, _, _, _, sinhd, mask = hpx.disc_candidates(
            nside, th, ph, rad, K_ring, K_phi)
        pix = pix.long()
        reach = SINHD_REACH / torch.clamp(sinhd, min=1e-300)
        x = (torch.log(torch.clamp(2.0 * sinhd * (D / a)[:, None],
                                   min=1e-300)) - ln_r0) / dlnr
        dx = reach / dlnr + 3e-5           # and float32's own ulps of x
        edge = (((sinhd - torch.sin(0.5 * rad)[:, None]).abs() <= SINHD_REACH)
                | (mask & ((x.abs() <= dx) | ((x - (n_r - 1)).abs() <= dx))))
        marginal[pix[edge]] = True
        tol = 1e-4 + slope[idx][:, None] * reach
        rtol.scatter_reduce_(0, pix[mask], tol[mask], "amax")
    return rtol, marginal


def _check_inputs(nside, halos, curves, acc_dtype):
    if not 1 <= nside <= hpx.MAX_NSIDE:
        raise ValueError(f"disc_paint: NSIDE {nside} outside "
                         f"[1, {hpx.MAX_NSIDE}] (int32 pixel math)")
    for name, dt in (("curves", curves.dtype), ("acc_dtype", acc_dtype)):
        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"disc_paint: unsupported {name} dtype {dt}")
    if curves.dim() != 2 or curves.shape[1] < 2:
        raise ValueError("disc_paint: curves must be (n_halos, n_r >= 2)")
    n = curves.shape[0]
    for k in HALO_COLUMNS:
        x = halos[k]
        if (x.dtype != torch.float64 or x.shape != (n,)
                or x.device != curves.device):
            raise ValueError(f"disc_paint: halos[{k!r}] must be a "
                             f"float64 ({n},) tensor on {curves.device}")
    if curves.device.type not in ("cpu", "cuda"):
        raise ValueError(f"disc_paint: unsupported device {curves.device}")


def disc_paint(nside, halos, curves, ln_r0, dlnr, log_curves,
               pixel_size=False, acc_dtype=torch.float64):
    """Paint every halo's profile curve on the pixels of its disc.

    nside      : HEALPix NSIDE (<= 8192)
    halos      : dict of float64 (n,) tensors: ``theta``, ``phi`` (disc
                 centre, rad), ``radius`` (angular disc radius), ``D``
                 (angular diameter distance), ``a`` (scale factor)
    curves     : (n, n_r) per-halo curves of Sigma a on the log-uniform
                 grid ln r = ln_r0 + i dlnr; their dtype (float32 or
                 float64) is the dtype of the geometry and the lookup
    log_curves : the curves hold logs (exp'd after the lerp), else raw
                 values
    pixel_size : multiply each pixel's value by pixarea D^2
    acc_dtype  : dtype of the painted map (float32 or float64)

    Returns the (npix,) map. Kernel K11 for tensors on CUDA, the plain
    version for tensors on the CPU.
    """
    _check_inputs(nside, halos, curves, acc_dtype)
    dev = curves.device
    if dev.type == "cpu":
        return disc_paint_plain(nside, halos, curves, float(ln_r0),
                                float(dlnr), bool(log_curves),
                                bool(pixel_size), acc_dtype)
    acc = torch.zeros(hpx.npix(nside), dtype=acc_dtype, device=dev)
    n, n_r = curves.shape
    if n == 0:
        return acc
    curves = curves.contiguous()
    cols = [halos[k].contiguous() for k in HALO_COLUMNS]
    sfx = {torch.float32: "f32", torch.float64: "f64"}
    fn = getattr(_build.library(), "bf_disc_paint_{}_{}".format(
        sfx[curves.dtype], sfx[acc_dtype]))
    with torch.cuda.device(dev):
        err = fn(nside, n, *[_build.ptr(c) for c in cols], _build.ptr(curves),
                 n_r, float(ln_r0), float(dlnr), int(bool(log_curves)),
                 int(bool(pixel_size)), hpx.nside2pixarea(nside),
                 _build.ptr(acc), _build.stream_of(acc))
    _build.check(err, "disc_paint")
    _build.launches["disc_paint"] += 1
    return acc
