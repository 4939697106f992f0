"""HEALPix (RING scheme) geometry as plain torch functions.

Port of ``baryonforge_tpu.ops.healpix``: the same equations, vectorised
over any leading shape, with the float math in ``dtype``. These are the
plain versions' geometry; the CUDA kernels carry the same math as device
functions in ``csrc/healpix.cuh``.

Integer math is int32 (valid for NSIDE <= 8192, ``MAX_NSIDE``).

Precision follows the JAX package, which runs with ``jax_enable_x64``: a
Python float combined with an int32 array there is a weak float64, so a
few "float32" intermediates are computed in float64 and rounded once.
Here they are written out: the ring step ``dphi = 2 pi / nr`` is computed
in float64 and cast, ``pix2ang`` finds its ring index through a float64
square root and forms ``j + 0.5`` in float64, and ``get_interp_weights``
wraps phi into [0, 2 pi) in the dtype of the phi it is given before the
cast. A Python float with an int32 tensor is float32 in torch, so every
such spot carries an explicit ``.double()``. ``jnp.round`` is
round-half-to-even, as ``torch.round`` is; ``jnp.mod`` and ``//`` are
floor operations, as ``torch.remainder`` and ``rounding_mode="floor"``.
"""

import math

import numpy as np
import torch

__all__ = ["MAX_NSIDE", "npix", "nside2pixarea", "ring_info",
           "ring_above_theta", "ring_theta", "pix2ang", "ang2pix",
           "get_interp_weights", "disc_pad_sizes", "disc_candidates",
           "fmod_near", "floor_fmod_near"]

MAX_NSIDE = 8192
_TWO_PI = 2.0 * math.pi


def npix(nside):
    return 12 * nside * nside


def nside2pixarea(nside):
    return 4.0 * np.pi / npix(nside)


def _int32(x):
    return x.to(torch.int32)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def fmod_near(a, n):
    """Plain version of csrc/healpix.cuh: fmod_near, for a float tensor
    ``a`` and a float ``n`` > 0 (rounded to a's dtype): fmod(a, n) as a,
    a - n or a + n, each exact, for -2 n < a < 2 n (a = -n, whose fmod is
    -0, excepted), and torch.fmod elsewhere; bitwise torch.fmod's."""
    n = torch.tensor(n, dtype=a.dtype, device=a.device)
    two = 2.0 * n
    return torch.where(
        (a > -n) & (a < n), a,
        torch.where((a >= n) & (a < two), a - n,
                    torch.where((a < -n) & (a > -two), a + n,
                                torch.fmod(a, n))))


def floor_fmod_near(a, n):
    """Plain version of csrc/healpix.cuh: floor_fmod_near, fmod_near moved
    into the divisor's sign (jnp.mod, torch.remainder)."""
    r = fmod_near(a, n)
    return torch.where((r != 0) & (r < 0), r + torch.tensor(
        n, dtype=a.dtype, device=a.device), r)


def ring_info(nside, i, dtype=torch.float64):
    """Per-ring data for int32 ring indices ``i`` (1 .. 4 nside - 1).

    Returns (start_pixel, n_in_ring, z_ring, shifted); ``shifted`` is 1.0
    where pixel centres sit at phi = (j + 0.5) * dphi."""
    N = nside
    ncap = 2 * N * (N - 1)
    north = i < N
    south = i > 3 * N
    i_s = 4 * N - i
    nr = torch.where(north, 4 * i,
                     torch.where(south, 4 * i_s, torch.full_like(i, 4 * N)))
    sp = torch.where(north, 2 * i * (i - 1),
                     torch.where(south, npix(nside) - 2 * i_s * (i_s + 1),
                                 ncap + (i - N) * 4 * N))
    i_f = i.to(dtype)
    i_sf = i_s.to(dtype)
    z = torch.where(north, 1.0 - i_f * i_f / (3.0 * N ** 2),
                    torch.where(south, -1.0 + i_sf * i_sf / (3.0 * N ** 2),
                                4.0 / 3.0 - 2.0 * i_f / (3.0 * N)))
    shifted = ((north | south) | ((i - N) % 2 == 0)).to(dtype)
    return sp, nr, z, shifted


def _rt6N(nside, dtype, device):
    return torch.sqrt(torch.tensor(6.0, dtype=dtype, device=device)) * nside


def ring_above_theta(nside, theta):
    """Index of the ring north of colatitude ``theta`` (0 if none), using
    the pole-conditioned half-angle form (ops/healpix.py:84-100)."""
    N = nside
    z = torch.cos(theta)
    polar = torch.abs(z) > 2.0 / 3.0
    rt6N = _rt6N(N, theta.dtype, theta.device)
    irn = _int32(torch.floor(rt6N * torch.sin(0.5 * theta)))
    irs = _int32(torch.floor(rt6N * torch.cos(0.5 * theta)))
    ring_pol = torch.where(z > 0, irn, 4 * N - irs - 1)
    ring_eq = _int32(torch.floor(N * (2.0 - 1.5 * z)))
    return torch.where(polar, ring_pol, ring_eq)


def ring_theta(nside, i, dtype=torch.float64):
    """Colatitude of int32 ring ``i``; cap rings use 2 arcsin(i/(sqrt(6) N))
    so float32 keeps full relative precision at the poles."""
    N = nside
    north = i < N
    south = i > 3 * N
    i_f = i.to(dtype)
    i_sf = (4 * N - i).to(dtype)
    rt6N = _rt6N(N, dtype, i.device)
    th_n = 2.0 * torch.asin(torch.clamp(i_f / rt6N, 0.0, 1.0))
    th_s = math.pi - 2.0 * torch.asin(torch.clamp(i_sf / rt6N, 0.0, 1.0))
    z_e = 4.0 / 3.0 - 2.0 * i_f / (3.0 * N)
    th_e = torch.acos(torch.clamp(z_e, -1.0, 1.0))
    return torch.where(north, th_n, torch.where(south, th_s, th_e))


def _cap_ring(p):
    """Cap ring index i with 2 i (i-1) <= p < 2 i (i+1), from a float64
    square root plus the two integer guards of ops/healpix.py:137-140."""
    i = _int32((1 + torch.sqrt(1.0 + 2.0 * p.double())) / 2.0)
    i = torch.where(2 * i * (i - 1) > p, i - 1, i)
    return torch.where(2 * i * (i + 1) <= p, i + 1, i)


def pixel_ring(nside, p):
    """Ring (1 .. 4 nside - 1, int32) of int32 pixels ``p``, as pix2ang
    finds it: the cap's float64 square root, the belt's floor division."""
    N = nside
    ncap = 2 * N * (N - 1)
    npx = npix(nside)
    belt = N + torch.div(p - ncap, 4 * N, rounding_mode="floor")
    return torch.where(p < ncap, _cap_ring(p),
                       torch.where(p >= npx - ncap,
                                   4 * N - _cap_ring(npx - 1 - p),
                                   belt)).to(torch.int32)


def pix2ang(nside, p, dtype=torch.float64):
    """Ring-scheme pixel centre -> (theta, phi), float math in ``dtype``."""
    p = p.to(torch.int32)
    N = nside
    ncap = 2 * N * (N - 1)
    npx = npix(nside)
    rt6N = _rt6N(N, dtype, p.device)

    i_n = _cap_ring(p)
    j_n = p - 2 * i_n * (i_n - 1)
    th_n = 2.0 * torch.asin(torch.clamp(i_n.to(dtype) / rt6N, 0.0, 1.0))
    phi_n = (math.pi / (2.0 * i_n.to(dtype))) * (j_n.double() + 0.5).to(dtype)

    pe = p - ncap
    i_e = N + _fdiv(pe, 4 * N)
    j_e = pe % (4 * N)
    z_e = 4.0 / 3.0 - 2.0 * i_e.to(dtype) / (3.0 * N)
    s_e = ((i_e - N) % 2 == 0).to(dtype)
    phi_e = (math.pi / (2.0 * N)) * (j_e + 0.5 * s_e)

    ps = npx - 1 - p
    i_ss = _cap_ring(ps)
    j_ss = ps - 2 * i_ss * (i_ss - 1)
    j_s = 4 * i_ss - 1 - j_ss
    th_s = math.pi - 2.0 * torch.asin(
        torch.clamp(i_ss.to(dtype) / rt6N, 0.0, 1.0))
    phi_s = (math.pi / (2.0 * i_ss.to(dtype))) \
        * (j_s.double() + 0.5).to(dtype)

    north = p < ncap
    south = p >= npx - ncap
    th_e = torch.acos(torch.clamp(z_e, -1.0, 1.0))
    theta = torch.where(north, th_n, torch.where(south, th_s, th_e))
    phi = torch.where(north, phi_n, torch.where(south, phi_s, phi_e))
    return theta, phi


def ang2pix(nside, theta, phi):
    """(theta, phi) -> ring-scheme pixel (int32), float math in the inputs'
    dtype."""
    N = nside
    ncap = 2 * N * (N - 1)
    z = torch.cos(theta)
    za = torch.abs(z)
    tt = torch.remainder(phi, _TWO_PI) / (0.5 * math.pi)     # in [0, 4)

    temp1 = N * (0.5 + tt)
    temp2 = N * z * 0.75
    jp = _int32(torch.floor(temp1 - temp2))
    jm = _int32(torch.floor(temp1 + temp2))
    ir = N + 1 + jp - jm
    kshift = 1 - (ir & 1)
    ip = _fdiv(jp + jm - N + kshift + 1, 2) % (4 * N)
    pix_eq = ncap + (ir - 1) * 4 * N + ip

    tp = tt - torch.floor(tt)
    rt6N = _rt6N(N, z.dtype, z.device)
    tmp = torch.where(z > 0, rt6N * torch.sin(0.5 * theta),
                      rt6N * torch.cos(0.5 * theta))
    jp_c = _int32(torch.floor(tp * tmp))
    jm_c = _int32(torch.floor((1.0 - tp) * tmp))
    ir_c = jp_c + jm_c + 1
    ip_c = _int32(torch.floor(tt * ir_c))
    # a float32 theta rounded past pi gives ir_c = 0; XLA's x % 0 is x
    ip_c = torch.where(ir_c == 0, ip_c,
                       ip_c % torch.where(ir_c == 0, 1, 4 * ir_c))
    pix_n = 2 * ir_c * (ir_c - 1) + ip_c
    pix_s = npix(nside) - 2 * ir_c * (ir_c + 1) + ip_c
    pix_cap = torch.where(z > 0, pix_n, pix_s)
    return torch.where(za <= 2.0 / 3.0, pix_eq, pix_cap)


def _ring_phi_neighbors(nside, ring, phi, dtype):
    """Two pixels bracketing ``phi`` in ``ring`` and the phi weight."""
    sp, nr, _, shifted = ring_info(nside, ring, dtype)
    dphi = (_TWO_PI / nr.double()).to(dtype)
    tmp = phi / dphi - 0.5 * shifted
    i1 = _int32(torch.floor(tmp))
    w = (phi - (i1 + 0.5 * shifted) * dphi) / dphi
    i2 = i1 + 1
    i1 = i1 % nr
    i2 = i2 % nr
    return sp + i1, sp + i2, w, ring_theta(nside, ring, dtype)


def get_interp_weights(nside, theta, phi, dtype=torch.float64):
    """4 neighbour pixels + bilinear weights for each (theta, phi), in
    healpy's ``get_interp_weights`` convention with the layout transposed:
    returns (pix int32 (..., 4), wgt (..., 4) in ``dtype``)."""
    N = nside
    theta = theta.to(dtype)
    phi = torch.remainder(phi, _TWO_PI).to(dtype)
    ir1 = ring_above_theta(N, theta)
    ir2 = ir1 + 1

    # ring data on valid rings; the pole branches overwrite below
    r1 = torch.clamp(ir1, 1, 4 * N - 1)
    r2 = torch.clamp(ir2, 1, 4 * N - 1)
    p0, p1, w_phi1, theta1 = _ring_phi_neighbors(N, r1, phi, dtype)
    p2, p3, w_phi2, theta2 = _ring_phi_neighbors(N, r2, phi, dtype)

    wgt0 = 1.0 - w_phi1
    wgt1 = w_phi1
    wgt2 = 1.0 - w_phi2
    wgt3 = w_phi2

    at_north = ir1 == 0
    at_south = ir2 == 4 * N

    wtheta = (theta - theta1) / torch.where(at_north | at_south,
                                            torch.ones_like(theta),
                                            theta2 - theta1)
    g0 = wgt0 * (1.0 - wtheta)
    g1 = wgt1 * (1.0 - wtheta)
    g2 = wgt2 * wtheta
    g3 = wgt3 * wtheta

    # north polar cap: point above ring 1
    wt_n = theta / theta2
    fac_n = (1.0 - wt_n) * 0.25
    n2 = wgt2 * wt_n + fac_n
    n3 = wgt3 * wt_n + fac_n
    pn0 = (p2 + 2) % 4
    pn1 = (p3 + 2) % 4

    # south polar cap: point below ring 4N-1
    wt_s = (theta - theta1) / (math.pi - theta1)
    fac_s = wt_s * 0.25
    s0 = wgt0 * (1.0 - wt_s) + fac_s
    s1 = wgt1 * (1.0 - wt_s) + fac_s
    npx = npix(N)
    ps2 = (p0 + 2) % 4 + npx - 4
    ps3 = (p1 + 2) % 4 + npx - 4

    pix = torch.stack([torch.where(at_north, pn0, p0),
                       torch.where(at_north, pn1, p1),
                       torch.where(at_south, ps2, p2),
                       torch.where(at_south, ps3, p3)], dim=-1)
    wgt = torch.stack([
        torch.where(at_north, fac_n, torch.where(at_south, s0, g0)),
        torch.where(at_north, fac_n, torch.where(at_south, s1, g1)),
        torch.where(at_north, n2, torch.where(at_south, fac_s, g2)),
        torch.where(at_north, n3, torch.where(at_south, fac_s, g3)),
    ], dim=-1)
    return pix, wgt


def disc_pad_sizes(nside, radius_max, sin_min=0.0):
    """Host-side (numpy): padded (K_ring, K_phi) window sizes covering every
    disc of angular radius <= radius_max whose colatitude band keeps
    sin(theta) >= sin_min (ops/healpix.py:340-376)."""
    N = nside
    i = np.arange(1, 4 * N)
    z = np.where(i < N, 1.0 - i ** 2 / (3.0 * N ** 2),
                 np.where(i > 3 * N, -1.0 + (4 * N - i) ** 2 / (3.0 * N ** 2),
                          4.0 / 3.0 - 2.0 * i / (3.0 * N)))
    theta = np.arccos(np.clip(z, -1, 1))
    dtheta_min = np.min(np.diff(theta))
    K_ring = int(np.ceil(2.0 * radius_max / dtheta_min)) + 3

    nr = np.where(i < N, 4 * i, np.where(i > 3 * N, 4 * (4 * N - i), 4 * N))
    dphi = 2.0 * np.pi / nr
    sin_t = np.maximum(np.sin(theta), 1e-12)
    sin_a = np.sin(min(radius_max, np.pi / 2))
    whole = sin_t <= sin_a
    half_w = np.where(whole, np.pi, np.arcsin(np.minimum(sin_a / sin_t, 1.0)))
    need = np.minimum(np.ceil(2.0 * half_w / dphi) + 3, nr)
    band = sin_t >= sin_min
    if not band.any():
        band = np.ones_like(band)
    K_phi = int(np.max(need[band]))
    return K_ring, K_phi


def disc_candidates(nside, theta0, phi0, radius, K_ring, K_phi,
                    dtype=torch.float64):
    """Padded disc query for a batch of discs, with each candidate's
    geometry (ops/healpix.py:379-431, vectorised over the leading halo
    axis instead of vmapped).

    theta0, phi0, radius : (n,) tensors (cast to ``dtype``)
    Returns (pix, cos_t, sin_t, dphi_pix, sinhd, mask), each
    (n, K_ring * K_phi): pixel ids, pixel-centre cos/sin colatitude, pixel
    phi minus phi0, the haversine sin(d/2) to the disc centre, and the
    membership mask (inside the disc, a valid ring, and no pixel twice when
    the window wraps a small ring).
    """
    N = nside
    dev = theta0.device
    theta0 = theta0.to(dtype)[:, None, None]
    phi0 = phi0.to(dtype)[:, None, None]
    radius = radius.to(dtype)[:, None, None]
    ring_top = torch.clamp(
        ring_above_theta(N, torch.clamp(theta0 - radius, min=0.0)),
        0, 4 * N - 1)
    rings = ring_top + 1 + torch.arange(K_ring, dtype=torch.int32,
                                        device=dev)[None, :, None]
    ring_ok = (rings >= 1) & (rings <= 4 * N - 1)
    rings_c = torch.clamp(rings, 1, 4 * N - 1)

    sp, nr, _, shifted = ring_info(N, rings_c, dtype)
    theta_r = ring_theta(N, rings_c, dtype)
    dphi = (_TWO_PI / nr.double()).to(dtype)
    jc = _int32(torch.round(phi0 / dphi - 0.5 * shifted))
    dp = (torch.arange(K_phi, dtype=torch.int32, device=dev)
          - (K_phi - 1) // 2)[None, None, :]
    jj = jc + dp                                       # (n, K_ring, K_phi)
    no_dup = (dp >= -_fdiv(nr - 1, 2)) & (dp <= _fdiv(nr, 2))
    jw = jj % nr
    pix = sp + jw

    cos_t = torch.cos(theta_r).expand(jj.shape)
    sin_t = torch.sin(theta_r).expand(jj.shape)
    dphi_pix = (jw + 0.5 * shifted) * dphi - phi0
    # haversine: sin^2(d/2) = sin^2(dtheta/2) + sin t sin t0 sin^2(dphi/2)
    sdt = torch.sin(0.5 * (theta_r - theta0))
    sdp = torch.sin(0.5 * dphi_pix)
    hav = sdt * sdt + sin_t * torch.sin(theta0) * (sdp * sdp)
    sinhd = torch.sqrt(torch.clamp(hav, 0.0, 1.0))
    mask = (sinhd <= torch.sin(0.5 * radius)) & no_dup & ring_ok
    n = jj.shape[0]
    return tuple(x.reshape(n, -1) for x in
                 (pix, cos_t, sin_t, dphi_pix, sinhd, mask))
