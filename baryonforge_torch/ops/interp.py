"""Table interpolation: multilinear readout and the per-halo curve collapse.

``collapse_curves`` is the wrapper of kernel K1 (``csrc/curves.cu``);
``collapse_curves_plain`` is its plain version, a port of
``baryonforge_tpu.ops.interp.collapse_curves``.
"""

import torch

from . import _build

__all__ = ["multilinear_interp", "collapse_curves", "collapse_curves_plain"]


def _locate(ax, x):
    """Bracketing index (searchsorted side="right", minus one, clamped to
    [0, n-2]), the fraction inside the bracket, and out-of-range flags."""
    i = torch.clamp(torch.searchsorted(ax, x, right=True) - 1,
                    0, ax.shape[0] - 2)
    t = (x - ax[i]) / (ax[i + 1] - ax[i])
    oob = (x < ax[0]) | (x > ax[-1])
    return i, t, oob


def multilinear_interp(grid_axes, values, points, fill_value=float("nan")):
    """Multilinear interpolation on a rectilinear grid.

    grid_axes : tuple of (Ni,) increasing tensors
    values    : (N1, ..., ND)
    points    : (Q, D)
    Outside the grid returns ``fill_value`` (the reference's
    RegularGridInterpolator(bounds_error=False, fill_value=nan)).
    """
    D = len(grid_axes)
    locs = [_locate(grid_axes[d], points[:, d].contiguous())
            for d in range(D)]
    oob = torch.zeros(points.shape[0], dtype=torch.bool,
                      device=points.device)
    for _, _, o in locs:
        oob = oob | o
    out = torch.zeros(points.shape[0], dtype=values.dtype,
                      device=values.device)
    for corner in range(2 ** D):
        w = torch.ones_like(out)
        loc = []
        for d, (i, t, _) in enumerate(locs):
            bit = (corner >> d) & 1
            w = w * (t if bit else 1.0 - t)
            loc.append(i + bit)
        out = out + w * values[tuple(loc)]
    return torch.where(oob, torch.full_like(out, fill_value), out)


def _halo_columns(table, M, a):
    dt, dev = table.dtype, table.device
    M_use = torch.atleast_1d(torch.as_tensor(M, dtype=dt, device=dev))
    a_use = torch.atleast_1d(torch.as_tensor(a, dtype=dt, device=dev))
    return M_use, a_use


def collapse_curves_plain(table, axes, r_axis, M, a, p_keys, kwargs,
                          fill=0.0):
    """Collapse every non-radial axis of a (z, M, r, p...) table at
    per-halo scalars, giving one radial curve per halo (plain version of
    K1; ops/interp.py:252-309 of the JAX package).

    table  : (N_z, N_M, N_r, N_p1, ...) with the radial axis at ``r_axis``
    axes   : per-axis grids (log(1+z), log M, log r, p...)
    M, a   : per-halo mass / scale factor (scalars or (n,))
    p_keys : names of the trailing parameter axes, values in ``kwargs``
    fill   : value for rows with any out-of-table coordinate

    Returns (curves (n, N_r), ln_r0, dlnr) in the table's dtype.
    """
    dt, dev = table.dtype, table.device
    M_use, a_use = _halo_columns(table, M, a)
    n = M_use.numel()
    vals = [torch.log(1.0 / a_use).expand(n), torch.log(M_use)]
    for k in p_keys:
        if k not in kwargs:
            raise ValueError(f"need {k} as input (table built with it)")
        vals.append(torch.as_tensor(kwargs[k], dtype=dt,
                                    device=dev).expand(n))
    axis_ids = [0, 1] + list(range(r_axis + 1, table.dim()))
    locs = [_locate(axes[ai], v.contiguous())
            for ai, v in zip(axis_ids, vals)]
    tab_t = table.permute(tuple(axis_ids) + (r_axis,))
    oob = locs[0][2]
    for loc in locs[1:]:
        oob = oob | loc[2]
    curves = torch.zeros((n, table.shape[r_axis]), dtype=dt, device=dev)
    for corner in range(2 ** len(locs)):
        w = torch.ones((n,), dtype=dt, device=dev)
        idx = []
        for d, (i, t, _) in enumerate(locs):
            bit = (corner >> d) & 1
            idx.append(i + bit)
            w = w * (t if bit else 1.0 - t)
        curves = curves + w[:, None] * tab_t[tuple(idx)]
    curves = torch.where(oob[:, None], torch.full_like(curves, fill), curves)
    ln_r = axes[r_axis]
    return curves, ln_r[0], ln_r[1] - ln_r[0]


def collapse_curves(table, axes, r_axis, M, a, p_keys, kwargs, fill=0.0):
    """Per-halo curve collapse: kernel K1 for a table on CUDA, the plain
    version for a table on the CPU. Same arguments and results as
    :func:`collapse_curves_plain`.

    The kernel takes (z, M, r) tables with the radial axis last and
    float32 or float64 values; tables with parameter axes (``p_keys``)
    raise on CUDA (ROADMAP Queue 2 row 7).
    """
    if table.device.type == "cpu":
        return collapse_curves_plain(table, axes, r_axis, M, a, p_keys,
                                     kwargs, fill)
    if table.device.type != "cuda":
        raise ValueError(f"collapse_curves: unsupported device {table.device}")
    if p_keys or table.dim() != 3 or r_axis != 2:
        raise NotImplementedError(
            "collapse_curves on CUDA takes (z, M, r) tables only; p_keys "
            "tables are ROADMAP Queue 2 row 7")
    dt = table.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"collapse_curves: unsupported dtype {dt}")
    ax_z, ax_M, ln_r = axes[0], axes[1], axes[2]
    for name, x in (("axis z", ax_z), ("axis M", ax_M), ("axis r", ln_r)):
        if x.dtype != dt or x.device != table.device or x.dim() != 1:
            raise ValueError(f"collapse_curves: {name} must be a 1-D "
                             f"{dt} tensor on {table.device}")
    nz, nM, nr = table.shape
    if ax_z.numel() != nz or ax_M.numel() != nM or ln_r.numel() != nr:
        raise ValueError("collapse_curves: axes do not match the table")
    if min(nz, nM, nr) < 2:
        raise ValueError("collapse_curves: every axis needs >= 2 points")
    table = table.contiguous()
    ax_z, ax_M = ax_z.contiguous(), ax_M.contiguous()
    M_use, a_use = _halo_columns(table, M, a)
    n = M_use.numel()
    a_use = a_use.expand(n).contiguous()
    M_use = M_use.contiguous()
    out = torch.empty((n, nr), dtype=dt, device=table.device)
    if n:
        fn = (_build.library().bf_collapse_curves_f32 if dt == torch.float32
              else _build.library().bf_collapse_curves_f64)
        with torch.cuda.device(table.device):
            err = fn(_build.ptr(table), _build.ptr(ax_z), _build.ptr(ax_M),
                     nz, nM, nr, _build.ptr(M_use), _build.ptr(a_use), n,
                     float(fill), _build.ptr(out), _build.stream_of(table))
        _build.check(err, "collapse_curves")
        _build.launches["collapse_curves"] += 1
    return out, ln_r[0], ln_r[1] - ln_r[0]
