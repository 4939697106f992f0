"""Spherical-harmonic analysis of RING-ordered HEALPix maps: the ring modes
and the Legendre transform, in float64.

``ring_modes`` is the wrapper of kernel K18 and ``legendre_alm`` of kernel
K19 (``csrc/sht.cu``), which replace ``_ring_modes`` and
``_alm_from_modes`` of the JAX package's ``utils/sht.py:49-150``;
``ring_modes_plain`` and ``legendre_alm_plain`` are their plain versions,
which follow the JAX formulas step by step (the angles m (j 2 pi / nr) of
each ring, the scan over l). Each wrapper launches its kernel for a tensor
on CUDA and runs the plain version for one on the CPU.

K18 runs one FFT a ring (``ring_plan`` groups the rings by route and
size), every phase an exact integer index, while the plain version rounds
the angle m (j dphi) as the JAX package does; ``ring_modes_tolerance``
bounds what that rounding can move.

K19 runs one recurrence for each pair of mirrored rings (``mirror_pairs``:
z' = -z exactly, so lambda_lm(z') = (-1)^(l-m) lambda_lm(z) bitwise) and
contracts it with the sum of the pair's modes where l - m is even and
their difference where it is odd; ``legendre_alm_pairs_plain`` is the
plain version of that layout. ``ring_heights`` gives the ring heights with
the south belt mirrored exactly, which ``utils.sht`` passes to K19, so
that every ring pairs.
"""

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build

__all__ = ["ring_geometry", "ring_heights", "ring_plan", "ring_modes",
           "ring_modes_plain", "ring_modes_tolerance", "mirror_pairs",
           "legendre_alm", "legendre_alm_plain", "legendre_alm_pairs_plain",
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


def ring_heights(nside):
    """Ring heights z (4 nside - 1,) numpy float64, mirrored exactly: as
    :func:`ring_geometry`'s, except that each ring of the south belt (ring
    index 2 nside < i <= 3 nside) takes the negated z of its mirror 4 nside
    - i. The JAX formula 4/3 - 2i/(3 nside) misses that by up to 2.2e-16
    there; its caps are exact mirrors already."""
    N = nside
    z = ring_geometry(N)[2]
    i = np.arange(1, 4 * N)
    south = (i > 2 * N) & (i <= 3 * N)
    z[south] = -z[4 * N - 1 - i[south]]
    return z


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


def shared_memory_optin(device):
    """The dynamic shared memory a block may opt in to on the CUDA
    ``device`` (bytes), as the card reports it (asked once a device)."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return _optin(index)


@functools.lru_cache(maxsize=None)
def _optin(index):
    v = _build.library().bf_shared_memory_optin(index)
    _build.check(min(v, 0), "shared_memory_optin")
    return v


@functools.lru_cache(maxsize=16)
def ring_plan(nside, smem_bytes):
    """K18's launch plan, numpy: (rings, groups). ``rings`` lists the ring
    ids group by group; ``groups`` (n_groups, 5) holds each group's first
    index into ``rings``, its count, its FFT size M, whether it runs
    Bluestein, and whether its working arrays fit ``smem_bytes`` of shared
    memory (else they take slots of device memory). A ring of n = nr / 2
    complex points runs a power-of-two FFT of M = n points when n is a
    power of two (4 M doubles), else Bluestein's of the least power of two
    M >= 2 n - 1 (6 M doubles); rings of one route and one M form a group,
    the longest M first."""
    _, nr, _, _ = ring_geometry(nside)
    n = nr // 2
    pow2 = (n & (n - 1)) == 0
    M = np.where(pow2, n, 1 << np.ceil(np.log2(2 * n - 1)).astype(np.int64))
    need = 8 * np.where(pow2, 4, 6) * M
    shared = need <= smem_bytes
    keys = sorted({(int(m), bool(b), bool(s))
                   for m, b, s in zip(M, ~pow2, shared)}, reverse=True)
    rings, groups = [], []
    for m, blue, sh in keys:
        ids = np.flatnonzero((M == m) & (~pow2 == blue) & (shared == sh))
        groups.append((sum(r.size for r in rings), ids.size, m, int(blue),
                       int(sh)))
        rings.append(ids)
    return (np.concatenate(rings).astype(np.int32),
            np.asarray(groups, dtype=np.int32))


def _ring_modes_kernel(hmap, nside, lmax, smem_bytes=None):
    """K18; ``smem_bytes`` bounds the shared memory a ring's FFT may take,
    by default what the card allows a block (rings that need more run on
    slots of device memory)."""
    dev = hmap.device
    sp, nr, _, phi0 = ring_geometry(nside)
    if smem_bytes is None:
        smem_bytes = shared_memory_optin(dev)
    rings, groups = ring_plan(nside, smem_bytes)
    L = lmax + 1
    Fr = torch.empty((nr.size, L), dtype=torch.float64, device=dev)
    Fi = torch.empty_like(Fr)
    geo = (torch.as_tensor(sp.astype(np.int64), device=dev),
           torch.as_tensor(nr.astype(np.int32), device=dev),
           torch.as_tensor((phi0 > 0).astype(np.int32), device=dev),
           torch.as_tensor(rings, device=dev))
    lib = _build.library()
    slots = [min(c, lib.bf_ring_modes_long_blocks()) * (6 if b else 4) * m
             for _, c, m, b, sh in groups if not sh]
    scratch = torch.empty(max(slots, default=0), dtype=torch.float64,
                          device=dev)
    hmap = hmap.contiguous()
    groups = np.ascontiguousarray(groups)
    with torch.cuda.device(dev):
        err = lib.bf_ring_modes_f64(
            L, _build.ptr(hmap), *[_build.ptr(x) for x in geo],
            len(groups), groups.ctypes.data_as(ctypes.c_void_p),
            _build.ptr(scratch) if slots else None, _build.ptr(Fr),
            _build.ptr(Fi), _build.stream_of(Fr))
    _build.check(err, "ring_modes")
    _build.count("ring_modes")
    return Fr, Fi


def log_factors(L, device):
    """logfac_m = sum_{k <= m} log((2k + 1) / (2k)), m = 0 .. L - 1, as the
    JAX package forms it (a cumulative sum), float64 on ``device``."""
    k = torch.arange(1, L, dtype=torch.float64, device=device)
    return torch.cat([torch.zeros(1, dtype=torch.float64, device=device),
                      torch.cumsum(torch.log((2 * k + 1) / (2 * k)), 0)])


def _legendre_rows(z, lmax):
    """The JAX scan's rows: yields (l, lambda) for l = 0 .. lmax, lambda
    the (n, L) values lambda_lm(z_r), zero for m > l."""
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
    prev = torch.zeros_like(lam_mm)
    prev2 = torch.zeros_like(lam_mm)
    zero = torch.zeros((), dtype=dt, device=dev)
    li_all = torch.arange(L, device=dev)
    for li in range(L):
        cur = a[li] * (z[:, None] * prev) - b[li] * prev2
        cur = torch.where(li == li_all[None, :], lam_mm,
                          torch.where(li < li_all[None, :], zero, cur))
        yield li, cur
        prev2, prev = prev, cur


def legendre_alm_plain(z, Fr, Fi, lmax, absolute=False):
    """Plain version of K19, the JAX scan: the (n_ring, L) rows of
    lambda_lm for l = 0 .. lmax, each contracted with the ring modes over
    the rings. With ``absolute`` the contraction takes |F| |lambda|
    instead: the scale of each sum, for stating a tolerance."""
    L = lmax + 1
    if absolute:
        Fr, Fi = Fr.abs(), Fi.abs()
    alm_r = torch.empty((L, L), dtype=torch.float64, device=z.device)
    alm_i = torch.empty_like(alm_r)
    for li, cur in _legendre_rows(z, lmax):
        c = cur.abs() if absolute else cur
        alm_r[:, li] = torch.sum(Fr * c, dim=0)
        alm_i[:, li] = torch.sum(Fi * c, dim=0)
    return alm_r, alm_i


def mirror_pairs(z):
    """K19's chains, numpy int32 (n_chain, 2): ring r with its mirror r' =
    n - 1 - r where z[r'] == -z[r] bitwise (r < r'), else ring r alone
    (r' = -1); the rings ascending by r, each in exactly one chain. ``z``
    is a numpy array."""
    z = np.asarray(z, dtype=np.float64)
    n = z.size
    r = np.arange(n)
    rm = n - 1 - r
    paired = (z[rm] == -z) & (r != rm)
    keep = ~paired | (r < rm)
    return np.stack([r[keep], np.where(paired, rm, -1)[keep]],
                    1).astype(np.int32)


def legendre_alm_pairs_plain(z, Fr, Fi, lmax):
    """Plain version of K19's layout: one recurrence a chain of
    :func:`mirror_pairs` (on the first ring's z), contracted with E = F_r
    + F_r' where l - m is even and O = F_r - F_r' where it is odd (F_r' =
    0 for a ring alone). The same function as :func:`legendre_alm_plain`,
    the sums in another order."""
    chains = mirror_pairs(z.cpu().numpy())
    dev = z.device
    r = torch.as_tensor(chains[:, 0].astype(np.int64), device=dev)
    r2 = torch.as_tensor(chains[:, 1].astype(np.int64), device=dev)
    alone = (r2 < 0)[:, None]
    L = lmax + 1
    m = torch.arange(L, device=dev)
    ev, od = [], []
    for F in (Fr, Fi):
        F2 = torch.where(alone, torch.zeros((), dtype=F.dtype, device=dev),
                         F[r2.clamp(min=0)])
        ev.append(F[r] + F2)
        od.append(F[r] - F2)
    alm_r = torch.empty((L, L), dtype=torch.float64, device=dev)
    alm_i = torch.empty_like(alm_r)
    for li, cur in _legendre_rows(z[r], lmax):
        even = ((li - m) % 2 == 0)[None, :]
        alm_r[:, li] = torch.sum(torch.where(even, ev[0], od[0]) * cur, 0)
        alm_i[:, li] = torch.sum(torch.where(even, ev[1], od[1]) * cur, 0)
    return alm_r, alm_i


def legendre_alm(z, Fr, Fi, lmax):
    """a_lm = sum over rings of F_rm lambda_lm(z_r), m, l = 0 .. lmax, with
    the normalised associated Legendre functions run up in l from
    lambda_mm.

    z : (n_ring,) float64 ring heights; Fr, Fi : (n_ring, lmax + 1) float64
    ring modes. Returns (alm_r, alm_i), each (lmax + 1, lmax + 1) float64
    indexed [m, l], zero for l < m. Kernel K19 for tensors on CUDA, the plain
    version for tensors on the CPU. The kernel runs one recurrence for each
    chain of :func:`mirror_pairs` (built on the host from z): rings whose
    heights are exact mirrors share one.
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
    chains = mirror_pairs(z.cpu().numpy())
    atomic = len(chains) > lib.bf_legendre_chains_per_block()
    alloc = torch.zeros if atomic else torch.empty
    alm_r = alloc((L, L), dtype=torch.float64, device=dev)
    alm_i = alloc((L, L), dtype=torch.float64, device=dev)
    logfac = log_factors(L, dev)
    args = [x.contiguous() for x in (z, Fr, Fi)]
    chains = torch.as_tensor(chains, device=dev)
    with torch.cuda.device(dev):
        err = lib.bf_legendre_alm_f64(
            n_ring, len(chains), L, *[_build.ptr(x) for x in args],
            _build.ptr(chains), _build.ptr(logfac), _build.ptr(alm_r),
            _build.ptr(alm_i), _build.stream_of(alm_r))
    _build.check(err, "legendre_alm")
    _build.count("legendre_alm")
    return alm_r, alm_i
