"""The scatter paint: each halo's profile painted on the pixels of its disc;
and the anisotropic paint's disc paint and finish.

``disc_paint`` is the wrapper of kernel K11 (``csrc/disc_paint.cu``);
``disc_paint_plain`` is its plain version, a port of the JAX runner's
``PaintProfilesShell._paint_device`` body (``make_body`` / ``one_halo`` /
``body``, baryonforge_tpu/Runners/HealpixRunner.py:1948-1989) over the
padded disc windows of ``ops.deposit``. Per member pixel, in the curves'
dtype: r_com = chord D / a, the curve lookup (log curves exp'd), / a, zero
if not finite, times pixarea D^2 for the per-pixel integral; summed into an
(npix,) map of the accumulator's dtype. There is no small-disc fallback
and no eps_max cut: the disc is the only cut. K11 walks each disc in K2's
flat layout (``ops.deposit.disc_walk_plain``, the same members);
``disc_paint_walk_plain`` is the plain version of that walk, the same
pixel values summed in its order.

``disc_paint_anis`` is the wrapper of kernel K13 (``csrc/disc_paint.cu``);
``disc_paint_anis_plain`` is its plain version, a port of the scatter body
of the JAX ``PaintProfilesAnisShell`` (HealpixRunner.py:2377-2428) over the
same disc windows: per member pixel r_sep = |pix2vec(pix) - vec_h| D (the
unit vectors in the curves' dtype, the rest in float64, as under x64), the
model's painting and the tracer's canvas (two lookups, each on its own
grid, divided by a), mfrac = canvas / Mtot[pix] orig[pix], the painting
times pixarea D^2 when asked, painting mfrac summed in float64. K13
walks each disc in K2's flat layout (``ops.deposit.disc_walk_plain``, the
same members) and takes a pixel's theta from its ring;
``pixel_angles`` (a check kernel) and ``pixel_angles_plain`` give every
pixel's angles that way or by pix2ang, which agree bit for bit.

``anis_finish`` is the wrapper of kernel K14 (``csrc/anis_finish.cu``);
``anis_finish_plain`` is its plain version: the JAX runners' last pass,
which weights the halo sum by orig / Mtot and adds the uniform-background
tracer term (HealpixRunner.py:2349-2360 tiled, 2440-2443 scatter;
Map2DRunner.py:792-796 grid).
"""

import math

import torch

from . import _build
from . import healpix as hpx
from .deposit import _chunks, disc_walk_plain

__all__ = ["disc_paint", "disc_paint_plain", "disc_paint_walk_plain",
           "disc_paint_anis",
           "disc_paint_anis_plain", "anis_finish", "anis_finish_plain",
           "pixel_angles", "pixel_angles_plain", "float32_tolerance",
           "HALO_COLUMNS", "SINHD_REACH", "VEC_SINHD_REACH"]

HALO_COLUMNS = ("theta", "phi", "radius", "D", "a")

# Two float32 evaluations of the paint whose transcendental functions differ
# in their last bits (the device's acosf against torch's) put a ring's
# colatitude theta_r in [0, pi] up to 4 ulps (4 x 2^-22) apart, where each
# is within 2; the haversine's sin((theta_r - theta0) / 2), and with it
# sin(d/2), then moves by up to 2^-21, absolute.
SINHD_REACH = 2.0 ** -21
# K13 measures a pixel by its float32 unit vector instead: theta up to 4
# ulps (4 x 2^-22) and sin/cos of theta and phi a few float32 ulps each move
# the vector by at most ~1.2e-6 < 2^-19, its chord and so sin(d/2) = chord
# / 2 by at most 2^-20.
VEC_SINHD_REACH = 2.0 ** -20

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


def disc_paint_walk_plain(nside, halos, curves, ln_r0, dlnr, log_curves,
                          pixel_size, acc_dtype):
    """Plain version of K11's walk: each disc's members in the flat order
    of ``ops.deposit.disc_walk_plain`` (halo by halo, ring by ring), each
    pixel's value as :func:`disc_paint_plain` forms it, summed with
    ``index_add_`` in that order. Arguments as :func:`disc_paint`."""
    dt, dev = curves.dtype, curves.device
    acc = torch.zeros(hpx.npix(nside), dtype=acc_dtype, device=dev)
    if curves.shape[0] == 0:
        return acc
    w = disc_walk_plain(nside, halos["theta"], halos["phi"],
                        halos["radius"], dt)
    m = w["member"]
    h, pix, sinhd = w["halo"][m], w["pix"][m], w["sinhd"][m]
    lookup = _lookup(log_curves)
    for q0 in range(0, h.numel(), _CHUNK_PIXELS):
        hq = h[q0:q0 + _CHUNK_PIXELS]
        D, a_t = halos["D"][hq], halos["a"][hq].to(dt)[:, None]
        r_com = 2.0 * sinhd[q0:q0 + _CHUNK_PIXELS, None] * D.to(dt)[:, None] \
            / a_t
        paint = lookup(curves[hq], ln_r0, dlnr, r_com) / a_t
        paint = torch.where(torch.isfinite(paint), paint,
                            torch.zeros_like(paint))
        if pixel_size:
            paint = paint * (hpx.nside2pixarea(nside) * D ** 2).to(dt)[:, None]
        acc.index_add_(0, pix[q0:q0 + _CHUNK_PIXELS], paint[:, 0]
                       .to(acc_dtype))
    return acc


def _log_slope(curves, dlnr, log_curves):
    """Each curve's largest |d ln v / d ln r| (float64)."""
    lc = curves.double() if log_curves else torch.log(curves.double().abs())
    return torch.nan_to_num((lc[:, 1:] - lc[:, :-1]).abs() / dlnr, nan=0.0,
                            posinf=0.0).amax(1)


def float32_tolerance(nside, halos, curves, ln_r0, dlnr, log_curves,
                      reach=SINHD_REACH, second=None):
    """How far two float32 paints (K10, K11 or K13 against a plain version)
    may differ per pixel when only the last bits of their transcendental
    functions do. Arguments as :func:`disc_paint`; curves of one sign.
    ``reach`` is how far sin(d/2) may move (``SINHD_REACH`` for the
    haversine of K10 and K11, ``VEC_SINHD_REACH`` for K13's unit vectors);
    ``second`` = (curves2, ln_r0_2, dlnr_2, log_curves2) is K13's second
    curve, whose slope adds to the first's.

    Near a halo's centre the float32 geometry is ill-conditioned: r moves
    by reach / sin(d/2) relative, and the painted value by S times that, S
    the largest |d ln v / d ln r| of the halo's curve (the sum of both
    curves' for a product). A pixel's relative tolerance is 1e-4 (rounding
    of the curve, lerp, exp and sums) plus the largest such term of the
    halos painting it. A pixel is marginal where one of its (halo, pixel)
    pairs sits within that reach of the disc's edge or a table's ends, so
    float32 may keep or drop it.

    Computed in float64 on the curves' device. Returns the (npix,) relative
    tolerances and the (npix,) marginal mask.
    """
    dev = curves.device
    npix = hpx.npix(nside)
    rtol = torch.zeros(npix, dtype=torch.float64, device=dev)
    marginal = torch.zeros(npix, dtype=torch.bool, device=dev)
    grids = [(curves.shape[1], ln_r0, dlnr)]
    slope = _log_slope(curves, dlnr, log_curves)
    if second is not None:
        c2, ln_r0_2, dlnr_2, log2 = second
        grids.append((c2.shape[1], ln_r0_2, dlnr_2))
        slope = slope + _log_slope(c2, dlnr_2, log2)
    for idx_np, K_ring, K_phi in _chunks(nside,
                                         halos["theta"].cpu().numpy(),
                                         halos["radius"].cpu().numpy(),
                                         _CHUNK_PIXELS):
        idx = torch.as_tensor(idx_np, device=dev)
        th, ph, rad, D, a = (halos[k][idx] for k in HALO_COLUMNS)
        pix, _, _, _, sinhd, mask = hpx.disc_candidates(
            nside, th, ph, rad, K_ring, K_phi)
        pix = pix.long()
        rel = reach / torch.clamp(sinhd, min=1e-300)
        lnr = torch.log(torch.clamp(2.0 * sinhd * (D / a)[:, None],
                                    min=1e-300))
        # membership is the haversine's in every kernel
        edge = (sinhd - torch.sin(0.5 * rad)[:, None]).abs() <= SINHD_REACH
        for n_r, r0, dl in grids:
            x = (lnr - r0) / dl
            dx = rel / dl + 3e-5           # and float32's own ulps of x
            edge |= mask & ((x.abs() <= dx) | ((x - (n_r - 1)).abs() <= dx))
        marginal[pix[edge]] = True
        tol = 1e-4 + slope[idx][:, None] * rel
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


def disc_paint_anis_plain(nside, halos, painting, canvas, mtot, orig,
                          pixel_size):
    """Plain version of K13: padded disc windows, vectorised over halo
    chunks, summed with ``index_add_``. Arguments as
    :func:`disc_paint_anis`."""
    curves_p, ln_r0_p, dlnr_p, log_p = painting
    curves_t, ln_r0_t, dlnr_t, log_t = canvas
    dt, dev = curves_p.dtype, curves_p.device
    acc = torch.zeros(hpx.npix(nside), dtype=torch.float64, device=dev)
    if curves_p.shape[0] == 0:
        return acc
    pixarea = hpx.nside2pixarea(nside)
    for idx_np, K_ring, K_phi in _chunks(nside,
                                         halos["theta"].cpu().numpy(),
                                         halos["radius"].cpu().numpy(),
                                         _CHUNK_PIXELS):
        idx = torch.as_tensor(idx_np, device=dev)
        th, ph, rad, D, a = (halos[k][idx] for k in HALO_COLUMNS)
        pix, _, _, _, _, mask = hpx.disc_candidates(nside, th, ph, rad,
                                                     K_ring, K_phi, dt)
        tp, pp = hpx.pix2ang(nside, pix, dt)
        st = torch.sin(tp)
        vec = torch.stack([st * torch.cos(pp), st * torch.sin(pp),
                           torch.cos(tp)], dim=-1)
        sth = torch.sin(th)
        vec_h = torch.stack([sth * torch.cos(ph), sth * torch.sin(ph),
                             torch.cos(th)], dim=-1).to(dt)
        diff = (vec - vec_h[:, None]).double() * D[:, None, None]
        a_t = a.to(dt).double()[:, None]
        r_com = torch.sqrt((diff ** 2).sum(-1)) / a_t
        vp = _lookup(log_p)(curves_p[idx], ln_r0_p, dlnr_p, r_com) / a_t
        vt = _lookup(log_t)(curves_t[idx], ln_r0_t, dlnr_t, r_com) / a_t
        vp = torch.where(torch.isfinite(vp), vp, torch.zeros_like(vp))
        vt = torch.where(torch.isfinite(vt), vt, torch.zeros_like(vt))
        pl = pix.long()
        mt = mtot[pl]
        mfrac = torch.where(mt > 0, vt / mt, torch.zeros_like(vt)) * orig[pl]
        if pixel_size:
            vp = vp * (pixarea * D ** 2)[:, None]
        val = vp * mfrac
        acc.index_add_(0, pl[mask], val[mask])
    return acc


def _check_curve(name, c, n, dev):
    if c.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported curve dtype {c.dtype}")
    if c.dim() != 2 or c.shape[0] != n or c.shape[1] < 2 or c.device != dev:
        raise ValueError(f"{name}: curves must be ({n}, n_r >= 2) tensors "
                         f"on {dev}")


def disc_paint_anis(nside, halos, painting, canvas, mtot, orig,
                    pixel_size=False):
    """The anisotropic paint's halo sum on the pixels of every halo's disc.

    nside    : HEALPix NSIDE (<= 8192)
    halos    : as :func:`disc_paint`
    painting : (curves, ln_r0, dlnr, log_curves) of the model: (n, n_r)
               curves of Sigma a on the grid ln r = ln_r0 + i dlnr; their
               dtype is the dtype of the pixels' unit vectors
    canvas   : the same for the tracer, in the same dtype, on its own grid
    mtot     : (npix,) float64 total-mass canvas, background included
    orig     : (npix,) float64 input map
    pixel_size : multiply the painting by pixarea D^2

    Returns the (npix,) float64 map of sum over halos of painting(r)
    canvas(r) / mtot orig. Kernel K13 for tensors on CUDA, the plain version
    for tensors on the CPU.
    """
    if not 1 <= nside <= hpx.MAX_NSIDE:
        raise ValueError(f"disc_paint_anis: NSIDE {nside} outside "
                         f"[1, {hpx.MAX_NSIDE}] (int32 pixel math)")
    cp, ct = painting[0], canvas[0]
    dev, n = cp.device, cp.shape[0]
    _check_curve("disc_paint_anis", cp, n, dev)
    _check_curve("disc_paint_anis", ct, n, dev)
    if ct.dtype != cp.dtype:
        raise TypeError("disc_paint_anis: painting and canvas curves differ "
                        "in dtype")
    npix = hpx.npix(nside)
    for name, x in (("mtot", mtot), ("orig", orig)):
        if x.dtype != torch.float64 or x.shape != (npix,) or x.device != dev:
            raise ValueError(f"disc_paint_anis: {name} must be a float64 "
                             f"({npix},) tensor on {dev}")
    for k in HALO_COLUMNS:
        x = halos[k]
        if x.dtype != torch.float64 or x.shape != (n,) or x.device != dev:
            raise ValueError(f"disc_paint_anis: halos[{k!r}] must be a "
                             f"float64 ({n},) tensor on {dev}")
    painting = (cp, float(painting[1]), float(painting[2]),
                bool(painting[3]))
    canvas = (ct, float(canvas[1]), float(canvas[2]), bool(canvas[3]))
    if dev.type == "cpu":
        return disc_paint_anis_plain(nside, halos, painting, canvas, mtot,
                                     orig, bool(pixel_size))
    if dev.type != "cuda":
        raise ValueError(f"disc_paint_anis: unsupported device {dev}")
    acc = torch.zeros(npix, dtype=torch.float64, device=dev)
    if n == 0:
        return acc
    cols = [halos[k].contiguous() for k in HALO_COLUMNS]
    curve_args = []
    for c, r0, dl, lg in (painting, canvas):
        curve_args += [_build.ptr(c.contiguous()), c.shape[1], r0, dl,
                       int(lg)]
    fn = getattr(_build.library(), "bf_disc_paint_anis_{}".format(
        "f32" if cp.dtype == torch.float32 else "f64"))
    with torch.cuda.device(dev):
        err = fn(nside, n, *[_build.ptr(c) for c in cols], *curve_args,
                 _build.ptr(mtot.contiguous()),
                 _build.ptr(orig.contiguous()), int(bool(pixel_size)),
                 hpx.nside2pixarea(nside), _build.ptr(acc),
                 _build.stream_of(acc))
    _build.check(err, "disc_paint_anis")
    _build.launches["disc_paint_anis"] += 1
    return acc


def pixel_angles_plain(nside, dtype, per_ring):
    """Plain version of :func:`pixel_angles`."""
    if not per_ring:
        p = torch.arange(hpx.npix(nside), dtype=torch.int32)
        return hpx.pix2ang(nside, p, dtype)
    N = nside
    rings = torch.arange(1, 4 * N, dtype=torch.int32)
    sp, nr, _, shifted = hpx.ring_info(N, rings, dtype)
    i = torch.repeat_interleave(rings, nr)
    j = torch.arange(hpx.npix(nside), dtype=torch.int32) \
        - torch.repeat_interleave(sp, nr)
    theta = hpx.ring_theta(N, i, dtype)
    cap = (i < N) | (i > 3 * N)
    ic = torch.where(i < N, i, 4 * N - i).to(dtype)
    phi_cap = (math.pi / (2.0 * ic)) * (j.double() + 0.5).to(dtype)
    s = torch.repeat_interleave(shifted, nr)
    phi_belt = (math.pi / (2.0 * N)) * (j + 0.5 * s)
    return theta, torch.where(cap, phi_cap, phi_belt)


def pixel_angles(nside, dtype, device, per_ring=True):
    """Every pixel's centre (theta, phi), (npix,) in ``dtype``: from
    pix2ang, or with ``per_ring`` as K13 takes them, its ring's colatitude
    (ring_theta) and pix2ang's phi formula on its ring and index
    (csrc/healpix.cuh: ring_pixel_phi). K13 takes a pixel's theta from its
    ring only because the two agree bit for bit; the card test holds them
    so. The device's kernel for a CUDA ``device``, the plain version for
    the CPU."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pixel_angles: unsupported dtype {dtype}")
    device = torch.device(device)
    if device.type == "cpu":
        return pixel_angles_plain(nside, dtype, bool(per_ring))
    if device.type != "cuda":
        raise ValueError(f"pixel_angles: unsupported device {device}")
    theta = torch.empty(hpx.npix(nside), dtype=dtype, device=device)
    phi = torch.empty_like(theta)
    fn = getattr(_build.library(), "bf_pixel_angles_{}".format(
        "f32" if dtype == torch.float32 else "f64"))
    with torch.cuda.device(device):
        err = fn(nside, int(bool(per_ring)), _build.ptr(theta),
                 _build.ptr(phi), _build.stream_of(theta))
    _build.check(err, "pixel_angles")
    _build.launches["pixel_angles"] += 1
    return theta, phi


def anis_finish_plain(halo_sum, mtot, orig, add, bgw, scale, tiled):
    """Plain version of K14. Arguments as :func:`anis_finish`."""
    og = orig
    if tiled:
        mt2 = mtot.double() + add
        good = mt2 > 0
        zero = torch.zeros_like(mt2)
        base = torch.where(good, halo_sum.double() * og / mt2, zero)
        bg = torch.where(good, add / mt2, zero) * og
        return base + bgw * bg
    mt = mtot.double()
    bg = torch.where(mt > 0, add / mt, torch.zeros_like(mt)) * og
    return halo_sum.double() * scale + bgw * bg


def anis_finish(halo_sum, mtot, orig, add, bgw, scale=1.0, tiled=False):
    """The anisotropic paint's last pass over the map.

    halo_sum : the halo sum, (n,) in float32 or float64
    mtot     : the total-mass canvas, (n,) in halo_sum's dtype
    orig     : (n,) float64 input map
    add      : the uniform background's mass a pixel, dV drho_m
    bgw      : background_val global_tracer_fraction
    scale    : multiplies the halo sum (res^2 for a grid painted with
               include_pixel_size); not used when ``tiled``
    tiled    : the tiled shell's form: mtot does not hold the background
               yet and the halo sum is weighted by orig / (mtot + add) here;
               else mtot holds it and the halo sum is already weighted

    Returns the (n,) float64 map. Kernel K14 for tensors on CUDA, the plain
    version for tensors on the CPU.
    """
    dev = halo_sum.device
    if halo_sum.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"anis_finish: unsupported dtype {halo_sum.dtype}")
    n = halo_sum.numel()
    if mtot.dtype != halo_sum.dtype or mtot.shape != halo_sum.shape \
            or halo_sum.dim() != 1 or mtot.device != dev:
        raise ValueError("anis_finish: mtot must match halo_sum's (n,) "
                         "shape, dtype and device")
    if orig.dtype != torch.float64 or orig.shape != (n,) \
            or orig.device != dev:
        raise ValueError(f"anis_finish: orig must be a float64 ({n},) "
                         f"tensor on {dev}")
    if dev.type == "cpu":
        return anis_finish_plain(halo_sum, mtot, orig, float(add),
                                 float(bgw), float(scale), bool(tiled))
    if dev.type != "cuda":
        raise ValueError(f"anis_finish: unsupported device {dev}")
    out = torch.empty(n, dtype=torch.float64, device=dev)
    fn = getattr(_build.library(), "bf_anis_finish_{}".format(
        "f32" if halo_sum.dtype == torch.float32 else "f64"))
    with torch.cuda.device(dev):
        err = fn(n, _build.ptr(halo_sum.contiguous()),
                 _build.ptr(mtot.contiguous()), _build.ptr(orig.contiguous()),
                 float(add), float(bgw), float(scale), int(bool(tiled)),
                 _build.ptr(out), _build.stream_of(out))
    _build.check(err, "anis_finish")
    _build.launches["anis_finish"] += 1
    return out
