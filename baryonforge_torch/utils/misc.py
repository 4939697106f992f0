"""Support helpers (port of ``baryonforge_tpu.utils.misc``): the robust
near-zero root finder, the FFTLog precision merge of profile algebra, the
pickling helper (``destory_Pk``: the port's Cosmology is a frozen
dataclass of numbers, always pickleable, so it is a no-op kept for API
parity), the cosmology-to-dict conversion and the ``log_time`` timing
decorator."""

import math
import warnings

import torch

from ..ops.interp import pchip_derivatives, pchip_eval

__all__ = ["safe_Pchip_minimize", "destory_Pk", "destroy_Pk",
           "build_cosmodict", "combine_fftpars", "log_time"]


def safe_Pchip_minimize(y, x, n_window=5):
    """Root of y(x) ~ 0 of each row via monotone interpolation around the
    first sign change (JAX ``utils/misc.py:22-54``, vmapped over rows by
    its callers); y (..., N), x (N,) or (..., N). Returns (...,).

    A PCHIP of x(y) on the 2 n_window points around the first crossing
    (the window clipped to [0, N - 2 n_window]), with y flipped to rise,
    stably sorted and made strictly increasing by a 1e-12 ramp, evaluated
    at y = 0. A row without a crossing gives +inf if all of it is
    positive, else x at its smallest |y|.
    """
    n = y.shape[-1]
    x = x.to(device=y.device, dtype=y.dtype).expand(y.shape)
    sign_change = (y[..., :-1] * y[..., 1:] <= 0) & (y[..., :-1] != y[..., 1:])
    has_root = sign_change.any(-1)
    # the first crossing (an integer cast: CUDA has no argmax of bool)
    i0 = torch.argmax(sign_change.to(torch.int32), dim=-1)
    lo = torch.clamp(i0 - n_window + 1, 0, n - 2 * n_window)
    window = lo[..., None] + torch.arange(2 * n_window, device=y.device)
    xw = torch.gather(x, -1, window)
    yw = torch.gather(y, -1, window)
    # x(y) needs y rising: flip a falling window
    dec = yw[..., -1:] < yw[..., :1]
    yw = torch.where(dec, -yw, yw)
    order = torch.argsort(yw, dim=-1, stable=True)
    yw_s, xw_s = torch.gather(yw, -1, order), torch.gather(xw, -1, order)
    # a tiny ramp makes the sorted y strictly increasing
    eps = ((yw_s[..., -1:] - yw_s[..., :1]).abs() + 1e-30) * 1e-12
    yw_s = yw_s + torch.arange(2 * n_window, dtype=y.dtype,
                               device=y.device) * eps
    d = pchip_derivatives(yw_s, xw_s)
    root = pchip_eval(yw_s, xw_s, d, torch.zeros_like(yw_s[..., :1]))[..., 0]

    all_pos = (y > 0).all(-1)
    nearest = torch.gather(x, -1, torch.argmin(y.abs(), dim=-1)[..., None])
    fallback = torch.where(all_pos, torch.full_like(root, math.inf),
                           nearest[..., 0])
    return torch.where(has_root, root, fallback)


def destory_Pk(cosmo):
    """API-parity no-op: the port's Cosmology is a frozen dataclass of
    numbers, always pickleable (the reference strips SwigPyObject P(k)
    caches, utils/misc.py:157-184)."""
    return cosmo


destroy_Pk = destory_Pk


def build_cosmodict(cosmo):
    """Cosmology -> the reference-style cosmo dict
    (``cosmo.core.build_cosmodict``)."""
    from ..cosmo.core import build_cosmodict as _b
    return _b(cosmo)


# merge rules per FFT-precision parameter (reference utils/misc.py:261-336)
_FFT_PRECISION_LOGIC = {
    "plaw_fourier": min,
    "padding_lo_fftlog": min,
    "padding_lo_extra": min,
    "padding_hi_fftlog": max,
    "padding_hi_extra": max,
    "n_per_decade": max,
}


def combine_fftpars(pars_a, pars_b):
    """Merge two FFTLog precision dicts with per-key min/max rules."""
    out = dict(pars_a)
    for k, v in pars_b.items():
        if k in out and out[k] is not None and v is not None:
            rule = _FFT_PRECISION_LOGIC.get(k)
            out[k] = rule(out[k], v) if rule else out[k]
        elif v is not None:
            out[k] = v
        elif k in out:
            warnings.warn(f"FFT parameter {k} is None in one operand; "
                          "keeping the defined value")
    return out


def log_time(fn=None, logger=print):
    """Decorator injecting a ``log_line_time(tag)`` checkpoint callback that
    prints the wall time since the call began (reference utils/debug.py:
    6-74 analog). Host clock: a checkpoint after queued CUDA work measures
    its launch, not its run, unless the caller synchronizes first."""
    import functools
    import time

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            marks = []

            def log_line_time(tag):
                marks.append((tag, time.perf_counter() - t0))
                logger(f"[log_time] {f.__name__}:{tag} "
                       f"+{marks[-1][1]:.3f}s")

            kwargs.setdefault("log_line_time", log_line_time)
            try:
                return f(*args, **kwargs)
            except TypeError:
                kwargs.pop("log_line_time", None)
                return f(*args, **kwargs)
        return wrapper

    return deco(fn) if fn is not None else deco
