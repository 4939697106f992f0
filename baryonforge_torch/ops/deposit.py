"""Scatter phase A: the per-halo disc deposit of tangent-angle offsets.

``disc_deposit`` is the wrapper of kernel K2 (``csrc/deposit.cu``);
``disc_deposit_plain`` is its plain version, a port of the JAX runner's
``_make_body_factory`` (``one_halo`` / ``body``) and its padded-window
loop ``_bucketed_accumulate`` / ``_prepare_groups``
(baryonforge_tpu/Runners/HealpixRunner.py:462-564, 849-953).

Both return the (npix, 2) accumulator of (d theta, sin theta d phi)
offsets in the curves' dtype. ``disc_walk_plain`` is the plain version of
the kernel's own layout of a disc (its rings, their phi spans and the flat
(ring, dp) index the threads walk), and ``disc_members_plain`` the member
set of the padded windows that ``disc_deposit_plain`` uses; the tests hold
one against the other.
"""

import math

import numpy as np
import torch

from . import _build
from . import healpix as hpx
from ..Profiles.BaryonCorrection import BaryonificationClass

_TWO_PI = 2.0 * math.pi

__all__ = ["disc_deposit", "disc_deposit_plain", "disc_walk_plain",
           "disc_members_plain", "SPLIT_RINGS"]

_HALO_COLUMNS = ("theta", "phi", "radius", "D", "a", "Rcom", "rscale")

# colatitude classes of _prepare_groups: a disc whose band keeps
# sin(theta) >= s gets the phi window of disc_pad_sizes(..., sin_min=s)
_SIN_CLASSES = (0.25, 0.05, 0.0)

# K2 and K13 walk a disc of more rings with a whole block (K2 counts no
# members there; csrc/healpix.cuh: kSplitRings)
SPLIT_RINGS = 32


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


def disc_members_plain(nside, halos, dtype, pixel_budget=1 << 22):
    """The disc members of ``disc_deposit_plain``'s padded windows, before
    its fewer-than-4 fallback: (halo ids, pixel ids), int64, sorted by
    halo then pixel. ``halos`` needs ``theta``, ``phi`` and ``radius``."""
    empty = torch.zeros(0, dtype=torch.int64, device=halos["theta"].device)
    hs, ps = [empty], [empty]
    for idx, cand in _windows(nside, halos, dtype, pixel_budget):
        pix, mask = cand[0], cand[5]
        hs.append(idx[:, None].expand_as(pix)[mask].long())
        ps.append(pix[mask].long())
    h, p = torch.cat(hs), torch.cat(ps)
    order = torch.argsort(h * (1 << 32) + p)
    return h[order], p[order]


def _ring_range(nside, theta, radius, dtype):
    """A disc's rings as K2 walks them: (ring_first int32, n_rings int64),
    from the ring below ring_above(theta - radius) to two rings past
    theta + radius, in ``dtype``."""
    N = nside
    theta0, rad = theta.to(dtype), radius.to(dtype)
    ring_first = torch.clamp(hpx.ring_above_theta(
        N, torch.clamp(theta0 - rad, min=0.0)), 0, 4 * N - 1) + 1
    ring_last = torch.clamp(hpx.ring_above_theta(
        N, torch.clamp(theta0 + rad, max=math.pi)) + 2, 1, 4 * N - 1)
    return ring_first, torch.clamp(ring_last - ring_first + 1, min=0).long()


def disc_walk_plain(nside, theta, phi, radius, dtype=torch.float64):
    """Plain version of the flat layout of each disc that K2 and K13 walk
    (csrc/healpix.cuh: flat_disc_walks), for float64 (n,) ``theta``, ``phi``,
    ``radius``; the geometry in ``dtype`` and the phi spans in float64, as
    the kernel computes them.

    Returns a dict: ``n_rings`` (n,) int64; ``span`` (n, max n_rings),
    each ring's candidate count (0 past the disc's rings), whose exclusive
    scan along the rings lays each disc out as one flat index; ``block``
    (n,) bool, the discs of more than SPLIT_RINGS rings that the whole
    block walks; and over the flat candidates, in walk order, ``halo``,
    ``q`` (flat index), ``pix``, ``sinhd`` (sin(d/2) to the disc centre, in
    ``dtype``) and ``member`` (the haversine test)."""
    N = nside
    dev = theta.device
    th64, ph64, rad64 = theta.double(), phi.double(), radius.double()
    theta0, phi0, rad = th64.to(dtype), ph64.to(dtype), rad64.to(dtype)
    ring_first, n_rings = _ring_range(nside, th64, rad64, dtype)
    R = max(int(n_rings.max()) if n_rings.numel() else 0, 1)
    k = torch.arange(R, device=dev)
    valid = k[None, :] < n_rings[:, None]
    rings = torch.clamp(ring_first[:, None] + k[None, :].to(torch.int32),
                        1, 4 * N - 1)
    sp, nr, _, shifted = hpx.ring_info(N, rings, dtype)
    theta_r = hpx.ring_theta(N, rings, dtype)
    dphi = (_TWO_PI / nr.double()).to(dtype)
    jc = torch.round(phi0[:, None] / dphi - 0.5 * shifted).to(torch.int32)
    lo = -torch.div(nr - 1, 2, rounding_mode="floor")
    hi = torch.div(nr, 2, rounding_mode="floor")
    # the exact disc/ring half-width in float64, plus two pixels
    s = torch.sin(theta_r.double()) * torch.sin(th64)[:, None]
    c = ((torch.cos(rad64)[:, None]
          - torch.cos(theta_r.double()) * torch.cos(th64)[:, None])
         / torch.where(s > 1e-12, s, torch.ones_like(s)))
    cut = (s > 1e-12) & (c > -1.0)
    half = torch.acos(torch.clamp(c, max=1.0))
    hw = torch.where(cut, torch.ceil(half / dphi.double()),
                     torch.zeros_like(half)).to(torch.int32) + 2
    lo = torch.where(cut, torch.maximum(lo, -hw), lo)
    hi = torch.where(cut, torch.minimum(hi, hw), hi)
    span = torch.where(valid, hi - lo + 1, torch.zeros_like(hi)).long()
    first = torch.cumsum(span, dim=1) - span

    # the flat candidates, ring by ring
    cell = span.reshape(-1)
    src = torch.repeat_interleave(torch.arange(cell.numel(), device=dev),
                                  cell)
    off = torch.arange(src.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(cell, 0) - cell, cell)
    halo = src // R

    def at(x):
        return x.reshape(-1)[src]

    dp = at(lo) + off.to(torch.int32)
    jw = torch.remainder(at(jc) + dp, at(nr))
    dphi_pix = (jw + 0.5 * at(shifted)) * at(dphi) - phi0[halo]
    th_r = at(theta_r)
    sdt = torch.sin(0.5 * (th_r - theta0[halo]))
    sdp = torch.sin(0.5 * dphi_pix)
    hav = sdt * sdt + torch.sin(th_r) * torch.sin(theta0)[halo] * (sdp * sdp)
    sinhd = torch.sqrt(torch.clamp(hav, 0.0, 1.0))
    member = sinhd <= torch.sin(0.5 * rad)[halo]
    return dict(n_rings=n_rings, span=span, block=n_rings > SPLIT_RINGS,
                halo=halo, q=first.reshape(-1)[src] + off,
                pix=(at(sp) + jw).long(), sinhd=sinhd, member=member)


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


def _check_inputs(nside, halos, curves):
    if not 1 <= nside <= hpx.MAX_NSIDE:
        raise ValueError(f"disc_deposit: NSIDE {nside} outside "
                         f"[1, {hpx.MAX_NSIDE}] (int32 pixel math)")
    if curves.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"disc_deposit: unsupported dtype {curves.dtype}")
    if curves.dim() != 2 or curves.shape[1] < 2:
        raise ValueError("disc_deposit: curves must be (n_halos, n_r >= 2)")
    n = curves.shape[0]
    for k in _HALO_COLUMNS:
        x = halos[k]
        if (x.dtype != torch.float64 or x.shape != (n,)
                or x.device != curves.device):
            raise ValueError(f"disc_deposit: halos[{k!r}] must be a "
                             f"float64 ({n},) tensor on {curves.device}")


def disc_deposit(nside, halos, curves, ln_r0, dlnr, eps_max):
    """Deposit every halo's tangent displacement on the pixels of its disc.

    nside   : HEALPix NSIDE (<= 8192)
    halos   : dict of float64 (n,) tensors: ``theta``, ``phi`` (disc centre,
              rad), ``radius`` (angular disc radius), ``D`` (angular
              diameter distance), ``a`` (scale factor), ``Rcom`` (comoving
              R_Delta), ``rscale`` (radius scale of the curve lookup)
    curves  : (n, n_r) per-halo displacement curves on the log-uniform
              radial grid ln r = ln_r0 + i dlnr; their dtype (float32 or
              float64) is the dtype of the geometry and the accumulator
    eps_max : displacement is zero beyond eps_max * Rcom

    Returns the (npix, 2) accumulator. Kernel K2 for tensors on CUDA, the
    plain version for tensors on the CPU.
    """
    _check_inputs(nside, halos, curves)
    dev = curves.device
    if dev.type == "cpu":
        return disc_deposit_plain(nside, halos, curves, float(ln_r0),
                                  float(dlnr), eps_max)
    if dev.type != "cuda":
        raise ValueError(f"disc_deposit: unsupported device {dev}")
    dt = curves.dtype
    acc = torch.zeros((hpx.npix(nside), 2), dtype=dt, device=dev)
    n, n_r = curves.shape
    if n == 0:
        return acc
    curves = curves.contiguous()
    cols = [halos[k].contiguous() for k in _HALO_COLUMNS]
    lib = _build.library()
    fn = lib.bf_disc_deposit_f32 if dt == torch.float32 \
        else lib.bf_disc_deposit_f64
    with torch.cuda.device(dev):
        err = fn(nside, n, *[_build.ptr(c) for c in cols],
                 _build.ptr(curves), n_r, float(ln_r0), float(dlnr),
                 float(eps_max), _build.ptr(acc), _build.stream_of(acc))
    _build.check(err, "disc_deposit")
    _build.launches["disc_deposit"] += 1
    return acc
