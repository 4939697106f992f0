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

``disc_radii`` is the wrapper of kernel K20 (``csrc/disc_direct.cu``), the
direct readout's first half for models without ``halo_curves`` (the JAX
bodies' direct branches, HealpixRunner.py:866-914, 1949-1972, 2379-2408):
each disc's members laid out in rows of ``ops.direct.row_layout``, with
their r and, for the displacement, their tangent geometry.
``disc_radii_plain`` is its plain version, on ``disc_walk_plain``'s members
and ``disc_deposit_plain``'s fallback. ``ops.paint.disc_apply`` (K21) is the
second half.
"""

import math

import numpy as np
import torch

from . import _build
from . import healpix as hpx
from ..Profiles.BaryonCorrection import BaryonificationClass


__all__ = ["disc_deposit", "disc_deposit_plain", "disc_walk_plain",
           "disc_members_plain", "disc_radii", "disc_radii_plain",
           "DIRECT_MODES", "SPLIT_RINGS"]

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
    ``dtype``), ``member`` (the haversine test), ``theta_r`` (the ring's
    colatitude) and ``dphi_pix`` (phi minus the centre's), both in
    ``dtype``."""
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
    dphi = hpx.ring_dphi(nr, dtype)
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
                pix=(at(sp) + jw).long(), sinhd=sinhd, member=member,
                theta_r=th_r, dphi_pix=dphi_pix)


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
    _build.count("disc_deposit")
    return acc


DIRECT_MODES = ("displace", "paint", "anis")
_DIRECT_COLUMNS = ("theta", "phi", "radius", "D", "a")


def _fallback_geometry(nside, th, ph, dt):
    """The 4 interpolation neighbours of each centre (th, ph float64 (m,))
    with their geometry as ``disc_deposit_plain`` forms it: (pix, cos_t,
    sin_t, dphi_pix, sinhd), each (m, 4)."""
    pix4, _ = hpx.get_interp_weights(nside, th, ph, dt)
    t4, p4 = hpx.pix2ang(nside, pix4, dt)
    st0 = torch.sin(th).to(dt)[:, None]
    dphi4 = (p4.double() - ph[:, None]).to(dt)
    sdp4 = torch.sin(0.5 * dphi4)
    sdt4 = torch.sin(0.5 * (t4.double() - th[:, None]))
    hav4 = sdt4 * sdt4 + (torch.sin(t4) * st0 * (sdp4 * sdp4)).double()
    return (pix4, torch.cos(t4), torch.sin(t4), dphi4,
            torch.sqrt(torch.clamp(hav4, 0.0, 1.0)).to(dt))


def _row_counts(mode, members):
    """Each halo's row length: its members, or 4 for a displacement disc
    of fewer (the fallback's 4 neighbours)."""
    if mode == "displace":
        return np.where(members < 4, 4, members)
    return members


def _rows_empty(n_slots, mode, dt, dev):
    rdt = torch.float64 if mode == "anis" else dt
    return dict(pix=torch.full((n_slots,), -1, dtype=torch.int32, device=dev),
                hid=torch.zeros(n_slots, dtype=torch.int32, device=dev),
                r=torch.zeros(n_slots, dtype=rdt, device=dev),
                geo=(torch.zeros((n_slots, 3), dtype=dt, device=dev)
                     if mode == "displace" else None))


def disc_radii_plain(nside, halos, mode, dtype):
    """Plain version of K20. Arguments and result as :func:`disc_radii`;
    the layout is ``ops.direct.row_layout``'s, on the host."""
    from . import direct
    dt = dtype
    dev = halos["theta"].device
    n = halos["theta"].shape[0]
    th, ph, rad = halos["theta"], halos["phi"], halos["radius"]
    w = disc_walk_plain(nside, th, ph, rad, dt)
    m = w["member"]
    h = w["halo"][m]
    members = torch.bincount(h, minlength=n).cpu().numpy()
    layout = direct.row_layout(_row_counts(mode, members), direct.ROW_BUDGET)
    rows = _rows_empty(layout.n_slots, mode, dt, dev)
    D, a = halos["D"], halos["a"]
    # each member's rank in its disc (the walk is halo-major)
    start = torch.cumsum(torch.bincount(h, minlength=n), 0) \
        - torch.bincount(h, minlength=n)
    rank = torch.arange(h.numel(), device=dev) - start[h]
    pix, sinhd = w["pix"][m], w["sinhd"][m]
    th_r, dphi = w["theta_r"][m], w["dphi_pix"][m]
    cos_t, sin_t = torch.cos(th_r), torch.sin(th_r)
    if mode == "displace":
        keep = torch.as_tensor(members >= 4, device=dev)[h]
        h, rank, pix, sinhd = h[keep], rank[keep], pix[keep], sinhd[keep]
        cos_t, sin_t, dphi = cos_t[keep], sin_t[keep], dphi[keep]
        few = np.nonzero(members < 4)[0]
        if few.size:
            fi = torch.as_tensor(few, device=dev)
            p4, c4, s4, d4, sh4 = _fallback_geometry(nside, th[fi], ph[fi],
                                                     dt)
            h = torch.cat([h, fi.repeat_interleave(4)])
            rank = torch.cat([rank, torch.arange(4, device=dev)
                              .repeat(few.size)])
            pix = torch.cat([pix, p4.reshape(-1).long()])
            cos_t = torch.cat([cos_t, c4.reshape(-1)])
            sin_t = torch.cat([sin_t, s4.reshape(-1)])
            dphi = torch.cat([dphi, d4.reshape(-1)])
            sinhd = torch.cat([sinhd, sh4.reshape(-1)])
    slot = torch.as_tensor(layout.base, device=dev)[h] + rank
    rows["pix"][slot] = pix.int()
    rows["hid"][slot] = h.int()
    if mode == "anis":
        tp, pp = hpx.pix2ang(nside, pix.int(), dt)
        st = torch.sin(tp)
        vec = torch.stack([st * torch.cos(pp), st * torch.sin(pp),
                           torch.cos(tp)], dim=-1)
        sth = torch.sin(th)
        vec_h = torch.stack([sth * torch.cos(ph), sth * torch.sin(ph),
                             torch.cos(th)], dim=-1).to(dt)
        diff = (vec - vec_h[h]).double() * D[h][:, None]
        rows["r"][slot] = torch.sqrt((diff ** 2).sum(-1)) / a[h]
        return rows, layout
    chord = 2.0 * sinhd
    D_t, a_t = D.to(dt)[h], a.to(dt)[h]
    rows["r"][slot] = chord * D_t / a_t
    if mode == "displace":
        st0, ct0 = torch.sin(th).to(dt)[h], torch.cos(th).to(dt)[h]
        rows["geo"][slot] = torch.stack(
            [ct0 * sin_t - st0 * cos_t * torch.cos(dphi),
             st0 * torch.sin(dphi),
             D_t * torch.where(chord > 0, chord, torch.ones_like(chord))], 1)
    return rows, layout


def _k20_count(fn, mode_id, nside, cols):
    """K20's count pass: (members (n,) int32, counts (n,) int64 each row's
    radii)."""
    n, dev = cols[0].numel(), cols[0].device
    members = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = fn(mode_id, nside, n, *[_build.ptr(c) for c in cols], 0,
                 _build.ptr(members), _build.ptr(counts), None, None, None,
                 None, None, _build.stream_of(counts))
    _build.check(err, "disc_radii")
    _build.count("disc_radii")
    return members, counts


def _k20_layout(counts):
    """K20's layout pass (one block): (base (n,) int64, order (n,) int64 the
    halos in (class, index) order, class_counts (CLASSES,) int32)."""
    from .direct import CLASSES
    n, dev = counts.numel(), counts.device
    base = torch.empty(n, dtype=torch.int64, device=dev)
    order = torch.empty(n, dtype=torch.int64, device=dev)
    class_counts = torch.empty(CLASSES, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().bf_disc_layout(
            n, _build.ptr(counts), _build.ptr(base), _build.ptr(order),
            _build.ptr(class_counts), _build.stream_of(counts))
    _build.check(err, "disc_radii")
    _build.count("disc_radii")
    return base, order, class_counts


def _k20_rows(n_slots, mode, dt, dev):
    """K20's rows, unfilled: the write pass writes every slot."""
    rdt = torch.float64 if mode == "anis" else dt
    return dict(pix=torch.empty(n_slots, dtype=torch.int32, device=dev),
                hid=torch.empty(n_slots, dtype=torch.int32, device=dev),
                r=torch.empty(n_slots, dtype=rdt, device=dev),
                geo=(torch.empty((n_slots, 3), dtype=dt, device=dev)
                     if mode == "displace" else None))


def _k20_write(fn, mode_id, nside, cols, members, base, rows):
    """K20's write pass: every disc's members and pads into ``rows``."""
    geo = rows["geo"]
    with torch.cuda.device(base.device):
        err = fn(mode_id, nside, cols[0].numel(),
                 *[_build.ptr(c) for c in cols], 1, _build.ptr(members),
                 None, _build.ptr(base), _build.ptr(rows["pix"]),
                 _build.ptr(rows["hid"]), _build.ptr(rows["r"]),
                 None if geo is None else _build.ptr(geo),
                 _build.stream_of(base))
    _build.check(err, "disc_radii")
    _build.count("disc_radii")


def disc_radii(nside, halos, mode, dtype):
    """Lay every halo's disc members out in rows for the direct readout.

    nside  : HEALPix NSIDE (<= 8192)
    halos  : dict of float64 (n,) tensors ``theta``, ``phi``, ``radius``,
             ``D``, ``a`` (as :func:`disc_deposit`'s)
    mode   : "displace" (BaryonifyShell: r = 2 sin(d/2) D / a in ``dtype``,
             the tangent geometry, and a disc of fewer than 4 members
             replaced by the 4 interpolation neighbours of its centre),
             "paint" (r as displace, no fallback) or "anis" (r = |pix2vec
             - vec_h| D / a in float64, the vectors in ``dtype``)
    dtype  : float32 or float64, the geometry's

    Returns (rows, layout): ``layout`` the ``ops.direct.RowLayout`` of the
    halos (grouped by their row lengths, as ``ops.direct.row_layout``
    groups them, under ``ops.direct.ROW_BUDGET`` as it is at the call),
    ``rows`` a dict over its slots: ``pix`` int32 (-1 in pad
    slots), ``hid`` int32 the halo (0 in pad slots), ``r`` (in ``dtype``,
    float64 for anis; 0 in pad slots) and ``geo`` (displace: (n_slots, 3)
    in ``dtype``, the tangent factors ct0 sin_t - st0 cos_t cos dphi and
    st0 sin dphi and D chord_safe, 0 in pad slots; else None). A row holds
    its disc's members in the walk's order. Kernel K20 for tensors on CUDA
    (three launches: the count pass, the layout pass, which forms the
    layout on the card, its counts, bases and halo ids held there, and the
    write pass; one copy of the CLASSES class counts to the host, which
    cuts the groups), the plain version for tensors on the CPU.
    """
    from . import direct
    if mode not in DIRECT_MODES:
        raise ValueError(f"disc_radii: mode {mode!r} not in {DIRECT_MODES}")
    if not 1 <= nside <= hpx.MAX_NSIDE:
        raise ValueError(f"disc_radii: NSIDE {nside} outside "
                         f"[1, {hpx.MAX_NSIDE}] (int32 pixel math)")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"disc_radii: unsupported dtype {dtype}")
    dev = halos["theta"].device
    n = halos["theta"].shape[0]
    for k in _DIRECT_COLUMNS:
        x = halos[k]
        if x.dtype != torch.float64 or x.shape != (n,) or x.device != dev:
            raise ValueError(f"disc_radii: halos[{k!r}] must be a float64 "
                             f"({n},) tensor on {dev}")
    if dev.type == "cpu":
        return disc_radii_plain(nside, halos, mode, dtype)
    if dev.type != "cuda":
        raise ValueError(f"disc_radii: unsupported device {dev}")
    cols = [halos[k].contiguous() for k in _DIRECT_COLUMNS]
    fn = getattr(_build.library(), "bf_disc_radii_{}".format(
        "f32" if dtype == torch.float32 else "f64"))
    mode_id = DIRECT_MODES.index(mode)
    members, counts = _k20_count(fn, mode_id, nside, cols)
    base, order, class_counts = _k20_layout(counts)
    class_counts = class_counts.tolist()    # the one copy to the host
    n_slots = direct.class_slots(class_counts)
    rows = _k20_rows(n_slots, mode, dtype, dev)
    _k20_write(fn, mode_id, nside, cols, members, base, rows)
    # the groups' ids are cut from order while the write pass runs
    groups = direct.class_groups(class_counts, order, direct.ROW_BUDGET)
    return rows, direct.RowLayout(counts, base, groups, n_slots)
