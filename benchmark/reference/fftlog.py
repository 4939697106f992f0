"""FFTLog: Hankel and spherical-Bessel transforms on log-uniform grids
(Hamilton 2000; the plain version of kernel K8). ``fht`` computes in
the dtype of its rows: float64 rows give complex128 transforms, float32
rows complex64 ones.

A frozen copy of the plain (CPU) version in ``baryonforge_torch/ops/fftlog.py`` at
the commit that added the benchmark, with the kernel wrappers left out, so
that it runs in plain PyTorch on any device. It is the benchmark's
reference: it imports nothing of the program and is not edited with it.
"""

import math

import torch

from .interp import interp


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
    """The biased log-grid Hankel transform of every
    row of ``a`` (..., N) on the log grid ``lx`` (N,), with ``q`` already
    off the Gamma poles. Two forward DFTs (``torch.fft``) with the kernel
    coefficients between them, as the JAX package's two ``_dft_pair``
    calls. Returns the (..., N) transform in ``a``'s dtype (without the k
    grid)."""
    N = lx.shape[0]
    dln = (lx[-1] - lx[0]) / (N - 1)
    ln_k0x0 = ln_kcrc - lx[-1] + lx[0]
    j = torch.arange(N, device=lx.device)
    b = a * torch.exp(-q * (lx - lx[0])).to(a.dtype)
    c = torch.fft.fft(b)
    d = (c / N) * _u_coefficients(N, dln, mu, q, ln_k0x0,
                                  lx.device).to(c.dtype)
    out = torch.fft.fft(d).real
    return torch.exp(-q * (ln_k0x0 + j * dln)).to(a.dtype) * out


def fht(x, a, mu, q=0.0, kcrc=1.0):
    """Discrete Hankel transform  ã(k) = ∫ a(x) J_mu(k x) k dx  of each row
    of ``a`` (..., N) on the increasing log-uniform grid ``x`` (N,), on
    ``a``'s device. Returns (k, ã(k)) with k log-uniform and k_c x_c =
    kcrc."""
    N = x.shape[-1]
    q = _safe_q(mu, q)
    lx, ln_kcrc = _fht_grids(torch.as_tensor(x, device=a.device), kcrc)
    dln = (lx[-1] - lx[0]) / (N - 1)
    j = torch.arange(N, device=lx.device)
    k = torch.exp(ln_kcrc - lx[-1] + j * dln)
    return k.to(a.dtype), fht_plain(a, lx, mu, q, ln_kcrc)


def _log_resample(x_src, y_src, x_query):
    """Linear interpolation in log-x (values linear), zero outside."""
    return interp(torch.log(x_query), torch.log(x_src), y_src, left=0.0,
                  right=0.0)


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
