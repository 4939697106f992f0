"""The rows of the displacement table: enclosed-mass curves and their
inversion into displacements (the plain version of kernel K9). The rows
are computed in the dtype of their inputs.

A frozen copy of the plain (CPU) version in ``baryonforge_torch/ops/table_rows.py`` at
the commit that added the benchmark, with the kernel wrappers left out, so
that it runs in plain PyTorch on any device. It is the benchmark's
reference: it imports nothing of the program and is not edited with it.
"""

import torch

from .integrate import cumulative_simpson_uniform
from .interp import masked_pchip_interp


# a row needs more valid points than these to be interpolated at all
ENCLOSED_MIN_PTS = 2


DISPLACEMENT_MIN_PTS = 5


def enclosed_mass_plain(intgd, dens, lnr_int, lnr_out):
    """Plain version of K9's first entry. ``intgd`` and ``dens`` (B, N) are
    the clipped integrand (mass per ln r step) and density on the log grid
    ``lnr_int`` (N,); returns the enclosed mass (B, Q) at exp(lnr_out),
    from the cumulative Simpson integral and a masked log-log PCHIP, NaN
    outside a row's valid range."""
    M_enc = cumulative_simpson_uniform(intgd, dx=1.0) + intgd[:, :1]
    valid = (dens > 0) & torch.isfinite(M_enc) & (M_enc > 0)
    y = torch.log(torch.where(valid, M_enc, torch.ones_like(M_enc)))
    return torch.exp(masked_pchip_interp(lnr_int[None, :], y, valid,
                                         lnr_out[None, :],
                                         min_pts=ENCLOSED_MIN_PTS))


def _scan_keep(ln_m, base_ok):
    """Points that exceed the running maximum of the kept points by more
    than 1e-5, among the ``base_ok`` ones (a scan along the last axis)."""
    safe = torch.where(base_ok & torch.isfinite(ln_m), ln_m,
                       torch.full_like(ln_m, -torch.inf))
    carry = torch.full_like(safe[:, 0], -torch.inf)
    keep = torch.empty_like(base_ok)
    for j in range(safe.shape[1]):
        k = safe[:, j] > carry + 1e-5
        carry = torch.where(k, safe[:, j], carry)
        keep[:, j] = k
    return keep & base_ok


def displacement_rows_plain(lnr, M_DMO, M_DMB):
    """Plain version of K9's second entry: per row of the enclosed masses
    (B, n) on the radii exp(lnr), d(r) = M_DMB^-1(M_DMO(r)) - r by two
    masked PCHIPs, with the reference's masking rules: points must be
    finite, differ between DMO and DMB by more than 1e-6 in ln M, and
    increase (running maximum, 1e-5); the first DMB point is always kept.
    NaN where the inversion fails (a row with 5 or fewer usable points is
    all NaN)."""
    r = torch.exp(lnr)
    ln_dmo, ln_dmb = torch.log(M_DMO), torch.log(M_DMB)
    fin_b, fin_o = torch.isfinite(ln_dmb), torch.isfinite(ln_dmo)
    neq = (ln_dmb - ln_dmo).abs() > 1e-6
    mask_b = _scan_keep(ln_dmb, fin_b & (neq | ~fin_o))
    mask_b[:, 0] = True
    mask_o = _scan_keep(ln_dmo, fin_o & (neq | ~fin_b))
    zero = torch.zeros_like(ln_dmo)
    ln_MDMO_r = masked_pchip_interp(lnr[None, :],
                                    torch.where(fin_o, ln_dmo, zero), mask_o,
                                    lnr[None, :],
                                    min_pts=DISPLACEMENT_MIN_PTS)
    ln_rb = masked_pchip_interp(torch.where(fin_b, ln_dmb, zero), lnr[None, :],
                                mask_b, ln_MDMO_r,
                                min_pts=DISPLACEMENT_MIN_PTS)
    d = torch.exp(ln_rb) - r
    return torch.where(torch.isfinite(d), d, torch.full_like(d, torch.nan))


def displacement_table_plain(intgd_o, dens_o, intgd_b, dens_b, lnr_int,
                             lnr):
    """Plain version of :func:`displacement_table`: the enclosed masses of
    both profiles at exp(lnr) and their inversion, as
    :func:`enclosed_mass_plain` (twice) then :func:`displacement_rows_plain`
    compute them."""
    return displacement_rows_plain(
        lnr, enclosed_mass_plain(intgd_o, dens_o, lnr_int, lnr),
        enclosed_mass_plain(intgd_b, dens_b, lnr_int, lnr))
