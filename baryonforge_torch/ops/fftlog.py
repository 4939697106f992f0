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

import math

import numpy as np
import torch

from . import _build
from .interp import interp
from .sht import shared_memory_optin

__all__ = ["loggamma", "fht", "fht_plain", "fht_plan", "fht_slots",
           "FHT_MAX_M",
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


def _u_coefficients(N, dln, mu, q, ln_k0x0, device):
    """Kernel coefficients U_mu(q + i w_m) (k0 x0)^(-i w_m), complex128.
    ``ln_k0x0`` stays in log space: the phase w ln(k0 x0) reaches thousands
    of radians."""
    m = _signed_freqs(N, device)
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


# the longest FFT K8 runs for a row (its M): a power of two up to this
# length, any other N up to half of it (Bluestein's M >= 2 N - 1). It is
# the longest FFT held against fht_plain on the card (a power of two and
# Bluestein); the kernel's own index math (int inside an array of M points,
# 64-bit offsets between arrays) would take M up to 2^30. Its device-memory
# slot is 32 bytes a point (48 with Bluestein): 4 GiB (6) at this M. Rows
# whose slot does not fit the free memory are refused too (fht_slots).
FHT_MAX_M = 1 << 27


def fht_plan(N, smem_bytes):
    """K8's route for rows of N points: (M, bluestein, in_shared). A power
    of two runs an FFT of M = N points (4 M doubles a row: the points, Re
    and Im, and the twiddles), any other N Bluestein's chirp convolution by
    FFTs of the least power of two M >= 2 N - 1 (6 M doubles, the chirp's
    spectrum too); the row's arrays sit in shared memory when they fit
    ``smem_bytes``, else in a slot of device memory."""
    bluestein = N & (N - 1) != 0
    M = 1 << (2 * N - 2).bit_length() if bluestein else N
    slot = (6 if bluestein else 4) * M
    return M, bluestein, slot * 8 <= smem_bytes


def fht_slots(B, M, bluestein, free_bytes, most):
    """Device-memory slots for K8's long rows: one a block, at most
    ``most`` (the kernel's block count) and at most the B rows, as many as
    9/10 of ``free_bytes`` hold, each 4 M doubles (6 M with Bluestein).
    Raises MemoryError when not even one fits."""
    slot = (6 if bluestein else 4) * M * 8
    fit = int(0.9 * free_bytes) // slot
    if fit < 1:
        raise MemoryError(f"fht on CUDA: an FFT of M = {M} points needs a "
                          f"device-memory slot of {slot} bytes; "
                          f"{int(free_bytes)} bytes are free")
    return min(max(B, 1), most, fit)


def _free_bytes(device):
    """Device memory a new tensor can take: the driver's free memory and
    what PyTorch's caching allocator holds unused."""
    free = torch.cuda.mem_get_info(device)[0]
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)


def _fht_kernel(x, a, mu, q, ln_kcrc, smem_bytes=None):
    """K8 on CUDA tensors: one block a row, one launch for the transform
    and the k grid. ``q`` is already off the Gamma poles; ``smem_bytes``
    overrides the shared memory a block may take (the card's opt-in by
    default), so a test can force the device-memory route, whose slots
    are sized to the free memory after the outputs are allocated
    (:func:`fht_slots`). Returns (k, the (..., N) transform)."""
    N = x.shape[-1]
    if N < 2:
        raise ValueError(f"fht on CUDA: N = {N} < 2")
    if smem_bytes is None:
        smem_bytes = shared_memory_optin(a.device)
    M, bluestein, in_shared = fht_plan(N, smem_bytes)
    if M > FHT_MAX_M:
        raise ValueError(f"fht on CUDA: N = {N} needs an FFT of {M} points, "
                         f"over FHT_MAX_M = {FHT_MAX_M}")
    rows = a.reshape(-1, N).to(torch.float64).contiguous()
    x = x.to(device=a.device, dtype=torch.float64).contiguous()
    B = rows.shape[0]
    lib = _build.library()
    k = torch.empty_like(x)
    out = torch.empty(a.shape, dtype=torch.float64, device=a.device)
    scratch, slots = None, 0
    if not in_shared:
        slots = fht_slots(B, M, bluestein, _free_bytes(a.device),
                          lib.bf_fht_long_blocks())
        scratch = torch.empty(slots * (6 if bluestein else 4) * M,
                              dtype=torch.float64, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.bf_fht_f64(
            B, N, M, int(bluestein), int(in_shared), slots, _build.ptr(rows),
            _build.ptr(x), float(mu), float(q), float(ln_kcrc),
            None if scratch is None else _build.ptr(scratch),
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
