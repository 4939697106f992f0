"""FFTLog: Hankel and spherical-Bessel transforms on log-uniform grids.

Port of ``baryonforge_tpu.ops.fftlog`` (Hamilton 2000): a(x) is expanded
as sum_m c_m x^(q + i w_m) on a periodic log grid, and each term goes
through the analytic Mellin pair
int_0^inf x^s J_mu(k x) dx = k^-(s+1) 2^s Gamma((mu+1+s)/2) /
Gamma((mu+1-s)/2). The JAX package writes everything in (re, im) float64
pairs because XLA:TPU has no complex128; here the plain version uses
native complex128.

``fht`` is the wrapper of kernel K8 (``csrc/fftlog.cu``) for a tensor on
CUDA and of its plain version ``fht_plain`` for one on the CPU. Everything
else (the kernel coefficients' host scalars, the grids, the wrappers)
follows the device of its inputs.
"""

import collections
import functools
import itertools
import math
import operator

import numpy as np
import torch

from . import _build
from .interp import interp
from .sht import shared_memory_optin

__all__ = ["loggamma", "fht", "fht_plain", "fht_plan", "fht_passes",
           "fht_slots", "fht_launches", "fht_positions",
           "fht_coeff_layout_plain", "fht_pass_fft_plain", "fht_route_plain",
           "FhtPlan", "PASS_POINTS", "PASS_COLUMN",
           "sph_fourier_3d", "sph_inverse_3d", "proj_fourier_2d",
           "proj_inverse_2d", "xi_from_pk", "convolve_profile"]

# Lanczos approximation, g=7, n=9 (the JAX package's coefficients; about
# 1e-13 relative over the domain FFTLog uses). csrc/fftlog.cu holds the
# same numbers.
_LANCZOS_G = 7.0
_LANCZOS_COEF = (
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
)


def _clog(re, im):
    return 0.5 * torch.log(re * re + im * im), torch.atan2(im, re)


def _log_sin_pi(zr, zi):
    """log(sin(pi (zr + i zi))), overflow-safe for large |zi|: for |zi| > 1
    it takes the exact form pi|zi| - ln 2 + i sgn(zi)(pi/2 - pi zr) +
    log(1 - e^(2 i pi zr - 2 pi |zi|)), whose correction term is tiny."""
    zia = zi.abs()
    big = zia > 1.0
    e = torch.exp(-2.0 * math.pi * zia)
    l1r, l1i = _clog(1.0 - e * torch.cos(2.0 * math.pi * zr),
                     -e * torch.sin(2.0 * math.pi * zr))
    sr_b = math.pi * zia - math.log(2.0) + l1r
    si_b = (0.5 * math.pi - math.pi * zr) + l1i
    # the direct branch, its argument clamped so the unused lane cannot
    # overflow
    zi_c = torch.clamp(zi, -2.0, 2.0)
    dr, di = _clog(torch.sin(math.pi * zr) * torch.cosh(math.pi * zi_c),
                   torch.cos(math.pi * zr) * torch.sinh(math.pi * zi_c))
    return (torch.where(big, sr_b, dr),
            torch.where(big, torch.sign(zi) * si_b, di))


def _loggamma_parts(zr, zi):
    """Principal-branch log Gamma of zr + i zi (float64 tensors), Lanczos
    with the reflection for zr < 1/2. Not valid at the poles (non-positive
    integers), which FFTLog's arguments avoid (``_safe_q``)."""
    reflect = zr < 0.5
    s = torch.complex(torch.where(reflect, 1.0 - zr, zr),
                      torch.where(reflect, -zi, zi))
    w = s - 1.0
    x = torch.full_like(w, _LANCZOS_COEF[0])
    for i in range(1, 9):
        x = x + _LANCZOS_COEF[i] / (w + i)
    t = w + _LANCZOS_G + 0.5
    ltr, lti = _clog(t.real, t.imag)
    lxr, lxi = _clog(x.real, x.imag)
    lgr = (0.5 * math.log(2.0 * math.pi) + (w.real + 0.5) * ltr
           - t.imag * lti - t.real + lxr)
    lgi = (w.real + 0.5) * lti + t.imag * ltr - t.imag + lxi
    lsr, lsi = _log_sin_pi(zr, zi)
    rr = math.log(math.pi) - lsr - lgr
    ri = -lsi - lgi
    return torch.where(reflect, rr, lgr), torch.where(reflect, ri, lgi)


def loggamma(z):
    """Principal-branch log Gamma of a complex tensor (complex128)."""
    z = torch.as_tensor(z).to(torch.complex128)
    re, im = _loggamma_parts(z.real, z.imag)
    return torch.complex(re, im)


def _signed_freqs(N, device):
    """``jnp.fft.fftfreq(N) * N``: the signed integer frequencies, with
    fftfreq's own rounding (k / N, then times N)."""
    k = torch.cat([torch.arange(0, (N - 1) // 2 + 1),
                   torch.arange(-(N // 2), 0)]).to(torch.float64)
    return (k / float(N)).to(device) * N


# frequencies a block of _u_coefficients: a longer row's coefficients are
# formed a block at a time (the same arithmetic on each), so their
# temporaries (a few dozen row-sized tensors) stay a block's
_U_BLOCK = 1 << 22


def _u_coefficients(N, dln, mu, q, ln_k0x0, device):
    """Kernel coefficients U_mu(q + i w_m) (k0 x0)^(-i w_m), complex128.
    ``ln_k0x0`` stays in log space: the phase w ln(k0 x0) reaches thousands
    of radians."""
    m = _signed_freqs(N, device)
    if N <= _U_BLOCK:
        return _u_of(m, N, dln, mu, q, ln_k0x0)
    out = torch.empty(N, dtype=torch.complex128, device=device)
    for s in range(0, N, _U_BLOCK):
        out[s:s + _U_BLOCK] = _u_of(m[s:s + _U_BLOCK], N, dln, mu, q,
                                    ln_k0x0)
    return out


def _u_of(m, N, dln, mu, q, ln_k0x0):
    """U at the signed frequencies ``m`` of a row of N points."""
    omega = 2.0 * math.pi * m / (N * dln)
    g1r, g1i = _loggamma_parts((mu + 1.0 + q) / 2.0 + 0 * omega, omega / 2.0)
    g2r, g2i = _loggamma_parts((mu + 1.0 - q) / 2.0 + 0 * omega,
                               -omega / 2.0)
    er = q * math.log(2.0) + g1r - g2r
    ei = omega * math.log(2.0) + g1i - g2i - omega * ln_k0x0
    e = torch.exp(er)
    return torch.complex(e * torch.cos(ei), e * torch.sin(ei))


def _safe_q(mu, q, eps=1e-4):
    """Nudge the bias q off the Gamma poles of U_mu ((mu+1+q)/2 = 0, -1,
    ...), as the reference does by hand (plaw_fourier = -3 + 1e-4)."""
    arg = (mu + 1.0 + q) / 2.0
    if arg <= 1e-8 and abs(arg - round(arg)) < eps:
        return q + eps
    return q


def _log_kcrc(kcrc):
    """log(kc rc) as the JAX package takes it: the host log of a number,
    else the array log of a tensor."""
    if isinstance(kcrc, (int, float)):
        return math.log(kcrc)
    return float(torch.log(torch.as_tensor(kcrc, dtype=torch.float64)
                           .reshape(1))[0])


def _fht_grids(x, kcrc):
    """(lx, ln_kcrc): the log grid and log(kc rc), both as the JAX package
    takes them (an array log for lx; the host log of a number kcrc)."""
    return torch.log(x.to(torch.float64)), _log_kcrc(kcrc)


def fht_plain(a, lx, mu, q, ln_kcrc):
    """Plain version of K8: the biased log-grid Hankel transform of every
    row of ``a`` (..., N) on the log grid ``lx`` (N,), with ``q`` already
    off the Gamma poles. Two forward DFTs (``torch.fft``) with the kernel
    coefficients between them, as the JAX package's two ``_dft_pair``
    calls. Returns the (..., N) float64 transform (without the k grid)."""
    N = lx.shape[0]
    dln = (lx[-1] - lx[0]) / (N - 1)
    ln_k0x0 = ln_kcrc - lx[-1] + lx[0]
    j = torch.arange(N, device=lx.device)
    b = (a * torch.exp(-q * (lx - lx[0]))).to(torch.float64)
    c = torch.fft.fft(b)
    d = (c / N) * _u_coefficients(N, dln, mu, q, ln_k0x0, lx.device)
    out = torch.fft.fft(d).real
    return torch.exp(-q * (ln_k0x0 + j * dln)) * out


# K8's passes over device memory (csrc/fftlog.cu): the points a block holds
# (Q, Re and Im: 64 KiB of shared memory) and the
# longest column a pass runs (a block then holds Q / R >= 4 columns side
# by side, so each row of them it loads or stores is a whole 32-byte
# sector of device memory)
PASS_POINTS = 4096
PASS_COLUMN = 1024
# A batch of at least as many rows as the card has SMs, each a power of two
# of at most this many points, runs one block a row on device memory
# instead: on the H100 at N = 8192 and 132 or 1000 rows it takes 0.87-0.95
# of the passes' time (200 rows: a tie); from 16,384 points on, and for
# Bluestein's rows, the passes take 0.36-0.88 of its time (device alone,
# chip_probes.py K8).
ROWS_MAX_M = 8192

FhtPlan = collections.namedtuple("FhtPlan", ["M", "bluestein", "in_shared",
                                             "passes"])
FhtPlan.__doc__ = """K8's route for rows of N points (:func:`fht_plan`):
``M`` the FFT's points (N for a power of two, else Bluestein's), whether
the row is ``bluestein``, whether it sits ``in_shared`` memory (one block
a row, one launch a call), else ``passes``, the radices R_0 .. R_{P-1} of
the route over the whole card (:func:`fht_passes`), or () for one block a
row on device memory (one launch a call)."""


def fht_passes(M, points=PASS_POINTS, column=PASS_COLUMN):
    """The radices of K8's passes for an FFT of M = 2^k points: the last
    pass's is the Q = min(M, points) points a block holds (a contiguous
    run of the row), the earlier passes split M / Q as evenly as they can
    into columns of at most ``column`` points (the larger radices first).
    Returns (R_0, ..., R_{P-1}), their product M."""
    Q = min(M, points)
    r = (M // Q).bit_length() - 1
    n = -(-r // (column.bit_length() - 1))
    bits = [r // n + (1 if i < r % n else 0) for i in range(n)]
    return tuple(1 << b for b in bits) + (Q,)


def fht_plan(N, smem_bytes, B=1, sms=None, points=PASS_POINTS,
             column=PASS_COLUMN):
    """K8's route for ``B`` rows of N points on a card of ``sms`` SMs, a
    :class:`FhtPlan`. A power of two runs an FFT of M = N points, any other
    N Bluestein's chirp convolution by FFTs of the least power of two M >=
    2 N - 1. One block a row in shared memory when the row's arrays fit
    ``smem_bytes`` (4 M doubles: the points, Re and Im, and the twiddles;
    6 M with Bluestein's chirp spectrum); else one block a row on a slot of
    device memory for a power of two N <= ROWS_MAX_M with rows for every
    SM; else the passes over device memory of :func:`fht_passes`, every
    block of the card on each pass."""
    bluestein = N & (N - 1) != 0
    M = 1 << (2 * N - 2).bit_length() if bluestein else N
    in_shared = (6 if bluestein else 4) * M * 8 <= smem_bytes
    rows = (sms is not None and B >= sms and not bluestein
            and M <= ROWS_MAX_M)
    return FhtPlan(M, bluestein, in_shared, () if in_shared or rows
                   else fht_passes(M, points, column))


def fht_slots(B, M, bluestein, free_bytes, fixed_bytes=0, most=None):
    """Rows of K8's scratch in device memory at once, as many as B and 9/10
    of ``free_bytes`` hold after ``fixed_bytes`` (what the call allocates
    besides: its output, the k grid, the rows' copy); at least one even
    without rows. The passes: 16 M bytes a row (Re and Im) beside 16 M for
    Bluestein's chirp (its sequence, then its spectrum) and the twiddles
    (16 bytes a point of a block). One block a row (``most`` blocks at most): a slot of 4
    M doubles a block (the points and the twiddles; 6 M with Bluestein).
    Raises MemoryError when not one fits."""
    row, shared = _scratch_bytes(M, bluestein, most)
    fit = (int(0.9 * free_bytes) - fixed_bytes - shared) // row
    if fit < 1:
        raise MemoryError(
            f"fht on CUDA: an FFT of M = {M} points needs {row + shared} "
            f"bytes of device-memory scratch and {fixed_bytes} for the "
            f"call's own tensors; {int(free_bytes)} bytes are free")
    return min(max(B, 1), fit, fit if most is None else most)


def _scratch_bytes(M, bluestein, most=None):
    """(bytes a row, bytes besides) of K8's device-memory scratch: the
    passes' (``most`` None), or one block a row's."""
    if most is None:
        return 16 * M, (16 * M if bluestein else 0) + 16 * PASS_POINTS
    return (6 if bluestein else 4) * 8 * M, 0


def fht_launches(plan, B, slots):
    """K8's launches for one call on ``B`` rows with ``slots`` rows of
    scratch: one in shared memory; on the passes a set-up (the k grid,
    the twiddles, Bluestein's chirp), Bluestein's P forward passes of its
    chirp (when there are rows), and for each group of up to ``slots`` rows
    the P forward passes, the coefficients and the P inverse passes, the
    two DFTs' for Bluestein."""
    if not plan.passes:
        return 1
    P = len(plan.passes)
    groups = -(-B // slots) if B else 0
    if plan.bluestein:
        return 1 + (P if groups else 0) + groups * (4 * P + 1)
    return 1 + groups * (2 * P + 1)


def _lg(n):
    return n.bit_length() - 1


def _pass_strides(passes):
    """S_p of each pass: the product of the later passes' radices."""
    return [math.prod(passes[p + 1:]) for p in range(len(passes))]


def fht_positions(M, passes):
    """Where the forward passes leave each frequency: the (M,) int64
    position of m = 0 .. M - 1 (digit k_p of m's mixed-radix digits, weight
    R_0 .. R_{p-1}, moves to weight S_p)."""
    m = torch.arange(M, dtype=torch.int64)
    pos = torch.zeros_like(m)
    for R, S, w in zip(passes, _pass_strides(passes),
                       itertools.accumulate((1,) + passes[:-1],
                                            operator.mul)):
        pos += ((m // w) % R) * S
    return pos


def fht_coeff_layout_plain(M, passes):
    """Plain version of the pass route's coefficient layout for a power of
    two (N = M): thread t of a row takes the position whose last-pass digit
    (its lowest) is below R_{P-1} / 2, i.e. a frequency m < N / 2, and the
    position of N - m (of N / 2 when m = 0). Returns (pos, m, partner)
    (M / 2,) int64."""
    R = passes[-1]
    t = torch.arange(M // 2, dtype=torch.int64)
    pos = (t // (R // 2)) * R + t % (R // 2)
    where = fht_positions(M, passes)
    freq = torch.empty_like(where)
    freq[where] = torch.arange(M, dtype=torch.int64)
    m = freq[pos]
    partner = where[torch.where(m > 0, M - m, M // 2)]
    return pos, m, partner


def fht_pass_fft_plain(z, passes, inverse=False):
    """Plain version of K8's passes on rows ``z`` (..., M) complex128, in
    the kernel's order: forward, pass p views a row as (M / L_p, R_p, S_p),
    runs the DFTs down its columns and multiplies output k of column c by
    e^{-2 pi i c k / L_p}, leaving frequency m at ``fht_positions(M,
    passes)[m]``; inverse (unnormalised), passes P - 1 .. 0, the conjugate
    twiddle and then the inverse DFTs, from that order back to natural."""
    M = z.shape[-1]
    lead = z.shape[:-1]
    steps = list(zip(passes, _pass_strides(passes)))
    for R, S in (reversed(steps) if inverse else steps):
        L = R * S
        v = z.reshape(*lead, M // L, R, S)
        ck = (torch.arange(R, dtype=torch.int64)[:, None]
              * torch.arange(S, dtype=torch.int64)[None, :])
        ph = math.pi * ((2 * ck).to(torch.float64) / L)
        w = torch.complex(torch.cos(ph), -torch.sin(ph)).to(z.device)
        if inverse:
            v = torch.fft.ifft(v * w.conj() if S > 1 else v, dim=-2,
                               norm="forward")
        else:
            v = torch.fft.fft(v, dim=-2)
            v = v * w if S > 1 else v
        z = v.reshape(*lead, M)
    return z


def _chirp_plain(N, device):
    """e^{-i pi (j^2 mod 2N) / N}, j < N (complex128)."""
    j = torch.arange(N, dtype=torch.int64)
    ph = math.pi * (((j * j) % (2 * N)).to(torch.float64) / N)
    return torch.complex(torch.cos(ph), -torch.sin(ph)).to(device)


def fht_route_plain(a, lx, mu, q, ln_kcrc, passes):
    """Plain version of K8's pass route: the transform of :func:`fht_plain`
    with both DFTs taken through :func:`fht_pass_fft_plain` in the kernel's
    order (a power of two: the coefficients applied at the positions of
    :func:`fht_coeff_layout_plain`, conjugated, and the inverse passes;
    Bluestein: two chirp convolutions by the spectrum of the chirp's
    sequence, in natural order). Returns the (..., N) float64 transform."""
    N = lx.shape[0]
    M = math.prod(passes)
    dev = lx.device
    dln = (lx[-1] - lx[0]) / (N - 1)
    ln_k0x0 = ln_kcrc - lx[-1] + lx[0]
    b = (a * torch.exp(-q * (lx - lx[0]))).to(torch.complex128)
    u = _u_coefficients(N, dln, mu, q, ln_k0x0, dev)
    if N == M:
        c = fht_pass_fft_plain(b, passes)
        pos, m, partner = (t.to(dev) for t in fht_coeff_layout_plain(
            M, passes))
        d = torch.empty_like(c)
        d[..., pos] = (c[..., pos] / N * u[m]).conj()
        d[..., partner] = (c[..., partner] / N * torch.where(
            m > 0, u[m].conj(), u[N // 2])).conj()
        o = fht_pass_fft_plain(d, passes, inverse=True).real
    else:
        ch = _chirp_plain(N, dev)
        seq = torch.zeros(M, dtype=torch.complex128, device=dev)
        seq[:N] = ch.conj()
        seq[M - N + 1:] = ch[1:].conj().flip(0)
        spec = fht_pass_fft_plain(seq, passes)

        def convolve(y):
            z = torch.zeros(y.shape[:-1] + (M,), dtype=torch.complex128,
                            device=dev)
            z[..., :N] = y
            return fht_pass_fft_plain(fht_pass_fft_plain(z, passes) * spec,
                                      passes, inverse=True)[..., :N]
        c = ch * (convolve(b * ch) / M)
        o = (ch * (convolve((c / N * u) * ch) / M)).real
    j = torch.arange(N, device=dev)
    return torch.exp(-q * (ln_k0x0 + j * dln)) * o


def _free_bytes(device, need=0):
    """Device memory a new tensor can take: the free memory
    cudaMemGetInfo reports, and what PyTorch's caching allocator holds
    unused when that alone does not hold 10/9 of ``need`` bytes (the
    allocator's statistics cost ~0.2 ms of host time)."""
    free = torch.cuda.mem_get_info(device)[0]
    if 0.9 * free >= need:
        return free
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fht_passes(lib, plan, rows, x, mu, q, ln_kcrc, k, out, slots):
    """K8's pass route on CUDA tensors: the set-up, then each group of up
    to ``slots`` rows through the forward passes, the coefficients and the
    inverse passes (Bluestein: its chirp's spectrum first, once a call),
    a launch each, counted."""
    B, N = rows.shape
    M, bluestein, passes = plan.M, plan.bluestein, plan.passes
    P, Q = len(passes), passes[-1]
    strides = _pass_strides(passes)
    lgs = sum(_lg(R) << (6 * p) for p, R in enumerate(passes))
    dev = rows.device
    stream = _build.stream_of(rows)
    tw = torch.empty(2 * (Q - 1), dtype=torch.float64, device=dev)
    chirp = (torch.empty(2 * M, dtype=torch.float64, device=dev)
             if bluestein else None)
    ptr_x, ptr_tw = _build.ptr(x), _build.ptr(tw)
    ptr_chirp = None if chirp is None else _build.ptr(chirp)

    def run(err):
        _build.check(err, "fht")
        _build.count("fht")

    def passes_over(scratch, G, forward, a=None, spec=None, out_g=None,
                    io=0):
        """The P passes of one direction over ``scratch`` (G rows): the
        first forward pass loads ``a`` (io 1 or 2), the last inverse pass
        stores ``out_g`` (io 1 or 2), the first inverse pass multiplies by
        ``spec``."""
        steps = range(P) if forward else range(P - 1, -1, -1)
        for i, p in enumerate(steps):
            end = p == 0
            run(lib.bf_fht_pass_f64(
                int(forward), io if end else 0, G, N, M, _lg(passes[p]),
                _lg(Q), strides[p],
                a if forward and end else None, ptr_x, float(q),
                float(ln_kcrc), ptr_tw,
                spec if not forward and i == 0 else None, scratch,
                out_g if not forward and end else None, stream))

    run(lib.bf_fht_setup_f64(N, M, Q, int(bluestein), ptr_x,
                             float(ln_kcrc), ptr_tw, ptr_chirp,
                             _build.ptr(k), stream))
    if B == 0:
        return
    if bluestein:
        passes_over(ptr_chirp, 1, True)
    scratch = torch.empty(2 * slots * M, dtype=torch.float64, device=dev)
    ptr_s = _build.ptr(scratch)
    for g0 in range(0, B, slots):
        G = min(slots, B - g0)
        a_g = _build.ptr(rows[g0:g0 + G])
        o_g = _build.ptr(out[g0:g0 + G])
        if bluestein:
            passes_over(ptr_s, G, True, a=a_g, io=2)
            passes_over(ptr_s, G, False, spec=ptr_chirp)
        else:
            passes_over(ptr_s, G, True, a=a_g, io=1)
        run(lib.bf_fht_coeff_f64(G, N, M, int(bluestein), P, lgs, ptr_x,
                                 float(mu), float(q), float(ln_kcrc), ptr_s,
                                 stream))
        if bluestein:
            passes_over(ptr_s, G, True)
            passes_over(ptr_s, G, False, spec=ptr_chirp, out_g=o_g, io=2)
        else:
            passes_over(ptr_s, G, False, out_g=o_g, io=1)


def _fht_kernel(x, a, mu, q, ln_kcrc, smem_bytes=None, sms=None):
    """K8 on CUDA tensors: the route of :func:`fht_plan`, the k grid too.
    ``q`` is already off the Gamma poles; ``smem_bytes`` and ``sms``
    override the shared memory a block may take and the SM count (the
    card's by default), so a test can force a route. The scratch on device
    memory is sized to the free memory before anything is allocated
    (:func:`fht_slots`, MemoryError when not one row fits). Returns (k,
    the (..., N) transform)."""
    N = x.shape[-1]
    if N < 2:
        raise ValueError(f"fht on CUDA: N = {N} < 2")
    dev = a.device
    if smem_bytes is None:
        smem_bytes = shared_memory_optin(dev)
    if sms is None and dev.type == "cuda":
        sms = _sm_count(dev.index if dev.index is not None
                        else torch.cuda.current_device())
    B = math.prod(a.shape[:-1])
    plan = fht_plan(N, smem_bytes, B, sms)
    slots, most = 0, None
    if not plan.in_shared:
        if not plan.passes:
            most = _build.library().bf_fht_long_blocks()
        copy = not (a.dtype == torch.float64 and a.is_contiguous())
        fixed = 8 * (B * N * (2 if copy else 1) + 2 * N)
        row, shared = _scratch_bytes(plan.M, plan.bluestein, most)
        want = max(B, 1) if most is None else min(max(B, 1), most)
        need = fixed + shared + row * want
        slots = fht_slots(B, plan.M, plan.bluestein, _free_bytes(dev, need),
                          fixed, most)
    rows = a.reshape(-1, N).to(torch.float64).contiguous()
    x = x.to(device=dev, dtype=torch.float64).contiguous()
    lib = _build.library()
    k = torch.empty_like(x)
    out = torch.empty(a.shape, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        if plan.passes:
            _fht_passes(lib, plan, rows, x, mu, q, ln_kcrc, k,
                        out.reshape(-1, N), slots)
            return k, out
        scratch = None if plan.in_shared else torch.empty(
            slots * (6 if plan.bluestein else 4) * plan.M,
            dtype=torch.float64, device=dev)
        err = lib.bf_fht_f64(
            B, N, plan.M, int(plan.bluestein), int(plan.in_shared), slots,
            _build.ptr(rows), _build.ptr(x), float(mu), float(q),
            float(ln_kcrc), None if scratch is None else _build.ptr(scratch),
            _build.ptr(k), _build.ptr(out), _build.stream_of(rows))
    _build.check(err, "fht")
    _build.count("fht")
    return k, out


def fht(x, a, mu, q=0.0, kcrc=1.0):
    """Discrete Hankel transform  ã(k) = ∫ a(x) J_mu(k x) k dx  of each row
    of ``a`` (..., N) on the increasing log-uniform grid ``x`` (N,).

    Returns (k, ã(k)) with k log-uniform and k_c x_c = kcrc. Runs kernel K8
    for ``a`` on CUDA and its plain version for ``a`` on the CPU."""
    N = x.shape[-1]
    q = _safe_q(mu, q)
    if a.device.type == "cuda":
        return _fht_kernel(torch.as_tensor(x, device=a.device), a, mu, q,
                           _log_kcrc(kcrc))
    if a.device.type != "cpu":
        raise ValueError(f"fht: unsupported device {a.device}")
    lx, ln_kcrc = _fht_grids(torch.as_tensor(x, device=a.device), kcrc)
    dln = (lx[-1] - lx[0]) / (N - 1)
    j = torch.arange(N, device=lx.device)
    k = torch.exp(ln_kcrc - lx[-1] + j * dln)
    return k, fht_plain(a, lx, mu, q, ln_kcrc)


def _log_resample(x_src, y_src, x_query):
    """Linear interpolation in log-x (values linear), zero outside."""
    return interp(torch.log(x_query), torch.log(x_src), y_src, left=0.0,
                  right=0.0)


def _padded_grid(r, pad_lo, pad_hi, n_per_decade):
    """Padded log grid covering [r0 pad_lo, r1 pad_hi] as host numpy, with
    a power-of-two length (at least 32)."""
    r0 = float(r[0]) * pad_lo
    r1 = float(r[-1]) * pad_hi
    n = int(np.ceil(np.log10(r1 / r0) * n_per_decade))
    n = int(2 ** np.ceil(np.log2(max(n, 32))))
    return np.geomspace(r0, r1, n)


# ---------------------------------------------------------------------------
# Physics-facing wrappers
# ---------------------------------------------------------------------------
def sph_fourier_3d(r, f, k_out, plaw=-2.0):
    """3D spherical Fourier transform F(k) = 4 pi ∫ r^2 f(r) j0(kr) dr of
    each row of f (..., N) on the log-uniform r, interpolated onto k_out.
    ``plaw`` is f's assumed power-law slope (the bias)."""
    a = f * r ** 1.5
    k, at = fht(r, a, mu=0.5, q=1.5 + plaw)
    F = (2.0 * math.pi) ** 1.5 * at / k ** 1.5
    return _log_resample(k, F, k_out)


def sph_inverse_3d(k, F, r_out, plaw=-2.0):
    """Inverse: f(r) = 1/(2 pi^2) ∫ k^2 F(k) j0(kr) dk."""
    return sph_fourier_3d(k, F, r_out, plaw=plaw) / (2.0 * math.pi) ** 3


def proj_fourier_2d(R, f, k_out, plaw=-2.0):
    """2D transform F(k) = 2 pi ∫ R f(R) J0(kR) dR."""
    a = f * R
    # 1.0 + plaw would sit on a Gamma pole
    k, at = fht(R, a, mu=0.0, q=1.5 + plaw)
    F = 2.0 * math.pi * at / k
    return _log_resample(k, F, k_out)


def proj_inverse_2d(k, F, R_out, plaw=-2.0):
    """Inverse 2D: f(R) = 1/(2 pi)^2 [2 pi ∫ k F(k) J0(kR) dk]."""
    return proj_fourier_2d(k, F, R_out, plaw=plaw) / (2.0 * math.pi) ** 2


def xi_from_pk(k, pk, r_out):
    """Matter correlation xi(r) = 1/(2 pi^2) ∫ k^2 P(k) j0(kr) dk."""
    return sph_inverse_3d(k, pk, r_out, plaw=-2.0)


def convolve_profile(r, f, window_fn, dim=3, plaw=-2.0):
    """FT^-1[FT[f](k) W(k)] for a radial profile f on the log-uniform r,
    both transforms on the natural reciprocal grids with opposite biases
    (so a unit window gives f back to rounding). ``window_fn`` maps k to
    W(k); dim=3 is the 3D transform, dim=2 the projected one."""
    if dim == 3:
        mu, p = 0.5, 1.5
        fwd_const, inv_const = (2.0 * math.pi) ** 1.5, \
            (2.0 * math.pi) ** -1.5
    else:
        mu, p = 0.0, 1.0
        fwd_const, inv_const = 2.0 * math.pi, (2.0 * math.pi) ** -1
    q = 1.5 + plaw
    k, at = fht(r, f * r ** p, mu=mu, q=q)
    F = fwd_const * at / k ** p
    F = F * window_fn(k)
    x, bt = fht(k, F * k ** p, mu=mu, q=-q)
    return inv_const * bt / x ** p
