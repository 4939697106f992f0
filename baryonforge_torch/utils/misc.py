"""Support helpers (the part of ``baryonforge_tpu.utils.misc`` the profile
framework needs): the FFTLog precision merge of profile algebra."""

import warnings

__all__ = ["combine_fftpars"]

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
