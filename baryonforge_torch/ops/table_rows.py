"""The rows of the displacement table: enclosed-mass curves and their
inversion into displacements (kernel K9, ``csrc/table_rows.cu``).

``displacement_table`` launches K9 once for a redshift's rows (both
profiles' enclosed masses and the inversion, fused) for CUDA tensors and
runs its plain version, ``displacement_table_plain``, for CPU tensors.
``enclosed_mass`` and ``displacement_rows`` run the two halves alone (the
same device code), with plain versions ``enclosed_mass_plain`` and
``displacement_rows_plain``. They are the device halves of
``baryonforge_tpu.Profiles.BaryonCorrection``'s ``_enclosed_mass_curve``
and ``_displacement_rows``; float64 throughout.
"""

import torch

from . import _build
from .integrate import cumulative_simpson_uniform
from .interp import masked_pchip_interp

__all__ = ["displacement_table", "displacement_table_plain",
           "enclosed_mass", "enclosed_mass_plain", "displacement_rows",
           "displacement_rows_plain", "ENCLOSED_MIN_PTS",
           "DISPLACEMENT_MIN_PTS"]

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


def _check(name, *ts):
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.float64 or t.device != dev:
            raise ValueError(f"{name}: every input must be float64 on "
                             f"{dev}")


def enclosed_mass(intgd, dens, lnr_int, lnr_out):
    """Enclosed-mass rows: K9 for CUDA tensors, the plain version for CPU
    ones (same arguments and result as :func:`enclosed_mass_plain`)."""
    _check("enclosed_mass", intgd, dens, lnr_int, lnr_out)
    if intgd.device.type == "cpu":
        return enclosed_mass_plain(intgd, dens, lnr_int, lnr_out)
    if intgd.device.type != "cuda":
        raise ValueError(f"enclosed_mass: unsupported device {intgd.device}")
    B, n = intgd.shape
    if dens.shape != (B, n) or lnr_int.shape != (n,) or lnr_out.dim() != 1:
        raise ValueError("enclosed_mass: intgd, dens (B, N); lnr_int (N,); "
                         "lnr_out (Q,)")
    if n < 3:
        raise ValueError("enclosed_mass: needs N >= 3 grid points")
    intgd, dens = intgd.contiguous(), dens.contiguous()
    lnr_int, lnr_out = lnr_int.contiguous(), lnr_out.contiguous()
    out = torch.empty((B, lnr_out.numel()), dtype=torch.float64,
                      device=intgd.device)
    if B:
        with torch.cuda.device(intgd.device):
            err = _build.library().bf_enclosed_mass_f64(
                B, n, lnr_out.numel(), _build.ptr(intgd), _build.ptr(dens),
                _build.ptr(lnr_int), _build.ptr(lnr_out), _build.ptr(out),
                _build.stream_of(intgd))
        _build.check(err, "enclosed_mass")
        _build.count("enclosed_mass")
    return out


def displacement_rows(lnr, M_DMO, M_DMB):
    """Displacement rows: K9's inversion alone for CUDA tensors, the plain
    version for CPU ones (same arguments and result as
    :func:`displacement_rows_plain`)."""
    _check("displacement_rows", lnr, M_DMO, M_DMB)
    if lnr.device.type == "cpu":
        return displacement_rows_plain(lnr, M_DMO, M_DMB)
    if lnr.device.type != "cuda":
        raise ValueError(f"displacement_rows: unsupported device "
                         f"{lnr.device}")
    n = lnr.numel()
    if lnr.dim() != 1 or M_DMO.dim() != 2 or M_DMO.shape != M_DMB.shape \
            or M_DMO.shape[1] != n:
        raise ValueError("displacement_rows: lnr (n,); M_DMO, M_DMB (B, n)")
    if n < 3:
        raise ValueError("displacement_rows: needs n >= 3 radii")
    lnr, M_DMO, M_DMB = lnr.contiguous(), M_DMO.contiguous(), \
        M_DMB.contiguous()
    B = M_DMO.shape[0]
    out = torch.empty((B, n), dtype=torch.float64, device=lnr.device)
    if B:
        with torch.cuda.device(lnr.device):
            err = _build.library().bf_displacement_rows_f64(
                B, n, _build.ptr(M_DMO), _build.ptr(M_DMB), _build.ptr(lnr),
                _build.ptr(out), _build.stream_of(lnr))
        _build.check(err, "displacement_rows")
        _build.count("displacement_rows")
    return out


def displacement_table(intgd_o, dens_o, intgd_b, dens_b, lnr_int, lnr):
    """A redshift's displacement rows (B, n_r) from the DMO and DMB
    profiles' clipped integrands and densities (B, N) on the log grid
    ``lnr_int`` (N,), at the radii exp(lnr) (n_r,): K9 in one launch for
    CUDA tensors, the plain version for CPU ones (same arguments and
    result as :func:`displacement_table_plain`). NaN where the inversion
    fails."""
    ts = (intgd_o, dens_o, intgd_b, dens_b, lnr_int, lnr)
    _check("displacement_table", *ts)
    dev = intgd_o.device
    if dev.type == "cpu":
        return displacement_table_plain(*ts)
    if dev.type != "cuda":
        raise ValueError(f"displacement_table: unsupported device {dev}")
    B, n = intgd_o.shape
    if any(t.shape != (B, n) for t in ts[1:4]) or lnr_int.shape != (n,) \
            or lnr.dim() != 1:
        raise ValueError("displacement_table: intgd_o, dens_o, intgd_b, "
                         "dens_b (B, N); lnr_int (N,); lnr (n_r,)")
    if n < 3 or lnr.numel() < 3:
        raise ValueError("displacement_table: needs N >= 3 grid points "
                         "and n_r >= 3 radii")
    ts = tuple(t.contiguous() for t in ts)
    out = torch.empty((B, lnr.numel()), dtype=torch.float64, device=dev)
    if B:
        with torch.cuda.device(dev):
            err = _build.library().bf_table_rows_f64(
                B, n, lnr.numel(), *(_build.ptr(t) for t in ts),
                _build.ptr(out), _build.stream_of(out))
        _build.check(err, "table_rows")
        _build.count("table_rows")
    return out
