"""Spherical-harmonic analysis of RING-ordered HEALPix maps: the ring modes
and the Legendre transform, in float64.

``ring_modes`` is the wrapper of kernel K18 and ``legendre_alm`` of kernel
K19 (``csrc/sht.cu``), which replace ``_ring_modes`` and
``_alm_from_modes`` of the JAX package's ``utils/sht.py:49-150``;
``ring_modes_plain`` and ``legendre_alm_plain`` are their plain versions,
which follow the JAX formulas step by step (the angles m (j 2 pi / nr) of
each ring, the scan over l). Each wrapper launches its kernel for a tensor
on CUDA and runs the plain version for one on the CPU.

K18 phases each term by the exact integer m j mod nr into a cosine table,
while the plain version rounds the angle m (j dphi) as the JAX package
does; ``ring_modes_tolerance`` bounds what that rounding can move.
"""

import math

import numpy as np
import torch

from . import _build

__all__ = ["ring_geometry", "ring_modes", "ring_modes_plain",
           "ring_modes_tolerance", "legendre_alm", "legendre_alm_plain",
           "log_factors"]


def ring_geometry(nside):
    """Per-ring (first pixel, pixel count, z, shifted phi0) of a RING map,
    numpy, as the JAX package's ``utils/sht._ring_geometry``."""
    N = nside
    i = np.arange(1, 4 * N)
    i_s = 4 * N - i
    nr = np.where(i < N, 4 * i, np.where(i > 3 * N, 4 * i_s, 4 * N))
    ncap = 2 * N * (N - 1)
    npx = 12 * N * N
    sp = np.where(i < N, 2 * i * (i - 1),
                  np.where(i > 3 * N, npx - 2 * i_s * (i_s + 1),
                           ncap + (i - N) * 4 * N))
    z = np.where(i < N, 1.0 - i ** 2 / (3.0 * N ** 2),
                 np.where(i > 3 * N, -1.0 + i_s ** 2 / (3.0 * N ** 2),
                          4.0 / 3.0 - 2.0 * i / (3.0 * N)))
    shifted = np.where((i < N) | (i > 3 * N), 1.0,
                       np.where((i - N) % 2 == 0, 1.0, 0.0))
    phi0 = 0.5 * shifted * (2.0 * np.pi / nr)
    return sp, nr, z, phi0


def _check_map(hmap, nside, name):
    if hmap.dtype != torch.float64 or tuple(hmap.shape) != (12 * nside ** 2,):
        raise ValueError(f"{name}: the map must be ({12 * nside ** 2},) "
                         "float64")


def ring_modes_plain(hmap, nside, lmax):
    """Plain version of K18, the JAX formulas: for the rings of each
    length nr, the angles m (j dphi) with dphi = 2 pi / nr, the sums of the
    values times cos and -sin, then the turn by m phi0."""
    sp, nr, _, phi0 = ring_geometry(nside)
    L = lmax + 1
    dev = hmap.device
    Fr = torch.empty((nr.size, L), dtype=torch.float64, device=dev)
    Fi = torch.empty_like(Fr)
    m = torch.arange(L, dtype=torch.float64, device=dev)
    for n in np.unique(nr):
        rows = np.flatnonzero(nr == n)
        idx = torch.as_tensor(sp[rows][:, None] + np.arange(n)[None, :],
                              device=dev)
        vals = hmap[idx]                                    # (rings, n)
        j = torch.arange(int(n), dtype=torch.float64, device=dev)
        ang = m[:, None] * (j[None, :] * (2.0 * np.pi / n))   # (L, n)
        cr = vals @ torch.cos(ang).T                        # (rings, L)
        ci = -(vals @ torch.sin(ang).T)
        p0 = torch.as_tensor(phi0[rows], device=dev)[:, None]
        c0, s0 = torch.cos(m * p0), torch.sin(m * p0)
        Fr[rows] = cr * c0 + ci * s0
        Fi[rows] = ci * c0 - cr * s0
    return Fr, Fi


def ring_modes_tolerance(hmap, nside, lmax):
    """(n_ring, L) bound on |K18 - plain| for each ring and m, from the
    plain version's angle rounding: its angle m (j dphi) is off by at most
    ~2 eps (2 pi m) and its turn m phi0 by eps pi m, its cos/sin by an ulp,
    and either sum of n terms by n eps of the sum of |values|; so
    8 eps (2 pi (m + 1) + n) sum_j |map_j| over the ring."""
    sp, nr, _, _ = ring_geometry(nside)
    a = hmap.abs()
    cs = torch.cat([torch.zeros(1, dtype=a.dtype, device=a.device),
                    torch.cumsum(a, 0)])
    s = (cs[torch.as_tensor(sp + nr, device=a.device)]
         - cs[torch.as_tensor(sp, device=a.device)])
    m = torch.arange(lmax + 1, dtype=torch.float64, device=a.device)
    n = torch.as_tensor(nr, dtype=torch.float64, device=a.device)
    eps = float(np.finfo(np.float64).eps)
    return 8 * eps * (2 * math.pi * (m[None, :] + 1) + n[:, None]) \
        * s[:, None]


def ring_modes(hmap, nside, lmax):
    """Ring modes F_m = e^{-i m phi0} sum_j map_j e^{-2 pi i m j / nr} of
    every ring of a RING map, m = 0 .. lmax.

    hmap : (12 nside^2,) float64. Returns (Fr, Fi), each (n_ring, lmax + 1)
    float64. Kernel K18 for a map on CUDA, the plain version for one on the
    CPU.
    """
    _check_map(hmap, nside, "ring_modes")
    dev = hmap.device
    if dev.type == "cpu":
        return ring_modes_plain(hmap, nside, lmax)
    if dev.type != "cuda":
        raise ValueError(f"ring_modes: unsupported device {dev}")
    return _ring_modes_kernel(hmap, nside, lmax)


def _ring_modes_kernel(hmap, nside, lmax, smem_ring=8192):
    """K18; ``smem_ring`` is the longest ring it stages in shared memory
    (longer rings compute each twiddle)."""
    dev = hmap.device
    sp, nr, _, phi0 = ring_geometry(nside)
    L = lmax + 1
    Fr = torch.empty((nr.size, L), dtype=torch.float64, device=dev)
    Fi = torch.empty_like(Fr)
    geo = (torch.as_tensor(sp.astype(np.int64), device=dev),
           torch.as_tensor(nr.astype(np.int32), device=dev),
           torch.as_tensor((phi0 > 0).astype(np.int32), device=dev))
    hmap = hmap.contiguous()
    with torch.cuda.device(dev):
        err = _build.library().bf_ring_modes_f64(
            nr.size, L, smem_ring, _build.ptr(hmap),
            *[_build.ptr(x) for x in geo], int(nr.max()), _build.ptr(Fr),
            _build.ptr(Fi), _build.stream_of(Fr))
    _build.check(err, "ring_modes")
    _build.launches["ring_modes"] += 1
    return Fr, Fi


def log_factors(L, device):
    """logfac_m = sum_{k <= m} log((2k + 1) / (2k)), m = 0 .. L - 1, as the
    JAX package forms it (a cumulative sum), float64 on ``device``."""
    k = torch.arange(1, L, dtype=torch.float64, device=device)
    return torch.cat([torch.zeros(1, dtype=torch.float64, device=device),
                      torch.cumsum(torch.log((2 * k + 1) / (2 * k)), 0)])


def legendre_alm_plain(z, Fr, Fi, lmax, absolute=False):
    """Plain version of K19, the JAX scan: the (n_ring, L) rows of
    lambda_lm for l = 0 .. lmax, each contracted with the ring modes over
    the rings. With ``absolute`` the contraction takes |F| |lambda|
    instead: the scale of each sum, for stating a tolerance."""
    dev = z.device
    L = lmax + 1
    dt = torch.float64
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    logfac = log_factors(L, dev)
    mf = torch.arange(L, dtype=dt, device=dev)
    log_s = torch.log(torch.clamp(s, min=float(np.finfo(np.float64).tiny)))
    lam_mm = torch.exp(0.5 * logfac[None, :] + mf[None, :] * log_s[:, None]
                       - 0.5 * math.log(4 * math.pi))
    edge = torch.where(mf == 0, torch.full_like(mf, 1.0 / math.sqrt(
        4 * math.pi)), torch.zeros_like(mf))
    lam_mm = torch.where(s[:, None] > 0, lam_mm, edge[None, :])
    l = mf[:, None]
    mm = mf[None, :]
    a = torch.sqrt(((2 * l + 1) * (2 * l - 1))
                   / torch.clamp((l - mm) * (l + mm), min=1.0))
    b = torch.sqrt(torch.clamp((2 * l + 1) * (l - 1 - mm) * (l - 1 + mm),
                               min=0.0)
                   / torch.clamp((2 * l - 3) * (l - mm) * (l + mm), min=1.0))
    if absolute:
        Fr, Fi = Fr.abs(), Fi.abs()
    alm_r = torch.empty((L, L), dtype=dt, device=dev)
    alm_i = torch.empty_like(alm_r)
    prev = torch.zeros_like(lam_mm)
    prev2 = torch.zeros_like(lam_mm)
    zero = torch.zeros((), dtype=dt, device=dev)
    li_all = torch.arange(L, device=dev)
    for li in range(L):
        cur = a[li] * (z[:, None] * prev) - b[li] * prev2
        cur = torch.where(li == li_all[None, :], lam_mm,
                          torch.where(li < li_all[None, :], zero, cur))
        c = cur.abs() if absolute else cur
        alm_r[:, li] = torch.sum(Fr * c, dim=0)
        alm_i[:, li] = torch.sum(Fi * c, dim=0)
        prev2, prev = prev, cur
    return alm_r, alm_i


def legendre_alm(z, Fr, Fi, lmax):
    """a_lm = sum over rings of F_rm lambda_lm(z_r), m, l = 0 .. lmax, with
    the normalised associated Legendre functions run up in l from
    lambda_mm.

    z : (n_ring,) float64 ring heights; Fr, Fi : (n_ring, lmax + 1) float64
    ring modes. Returns (alm_r, alm_i), each (lmax + 1, lmax + 1) float64
    indexed [m, l], zero for l < m. Kernel K19 for tensors on CUDA, the plain
    version for tensors on the CPU.
    """
    L = lmax + 1
    dev = z.device
    n_ring = z.numel()
    for name, x, shape in (("z", z, (n_ring,)), ("Fr", Fr, (n_ring, L)),
                           ("Fi", Fi, (n_ring, L))):
        if (tuple(x.shape) != shape or x.dtype != torch.float64
                or x.device != dev):
            raise ValueError(f"legendre_alm: {name} must be {shape} float64 "
                             f"on {dev}")
    if dev.type == "cpu":
        return legendre_alm_plain(z, Fr, Fi, lmax)
    if dev.type != "cuda":
        raise ValueError(f"legendre_alm: unsupported device {dev}")
    lib = _build.library()
    atomic = n_ring > lib.bf_legendre_rings_per_block()
    alloc = torch.zeros if atomic else torch.empty
    alm_r = alloc((L, L), dtype=torch.float64, device=dev)
    alm_i = alloc((L, L), dtype=torch.float64, device=dev)
    logfac = log_factors(L, dev)
    args = [x.contiguous() for x in (z, Fr, Fi)]
    with torch.cuda.device(dev):
        err = lib.bf_legendre_alm_f64(
            n_ring, L, *[_build.ptr(x) for x in args], _build.ptr(logfac),
            _build.ptr(alm_r), _build.ptr(alm_i), _build.stream_of(alm_r))
    _build.check(err, "legendre_alm")
    _build.launches["legendre_alm"] += 1
    return alm_r, alm_i
