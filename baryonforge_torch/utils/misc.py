"""Support helpers (the part of ``baryonforge_tpu.utils.misc`` the profiles
need): the robust near-zero root finder and the FFTLog precision merge of
profile algebra."""

import math
import warnings

import torch

from ..ops.interp import pchip_derivatives, pchip_eval

__all__ = ["safe_Pchip_minimize", "combine_fftpars"]


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
