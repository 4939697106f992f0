"""Interpolation: PCHIP, masked PCHIP, cubic splines, linear and
multilinear interpolation, and the per-halo curve collapse.

Port of ``baryonforge_tpu.ops.interp``. The 1-D interpolators take a
batch: ``x`` and ``y`` are (..., N) and broadcast against each other, and
queries are (..., Q). ``collapse_curves`` is the wrapper of kernel K1
(``csrc/curves.cu``), ``CurveTable`` its set-up once a table (which the
models keep: ``cast_copy``, ``curve_table``); ``collapse_curves_plain``
is its plain version, ``halo_corners_plain`` the plain version of its
per-halo step.
"""

import copy
import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["searchsorted_right", "pchip_derivatives", "pchip_eval",
           "pchip_interp", "masked_pchip_interp", "spline_system",
           "cubic_spline_coeffs", "cubic_spline_eval",
           "cubic_spline_derivative_eval",
           "interp", "interp1d_linear", "multilinear_interp",
           "collapse_curves", "collapse_curves_plain", "halo_corners_plain",
           "CurveTable", "cast_copy", "curve_table", "MAX_P_AXES"]

# parameter axes K1 takes besides z and M (kMaxAxes - 2 in csrc/curves.cu)
MAX_P_AXES = 4


def _lt_nan_last(a, b):
    """a < b in sort order, NaN above everything (lax's sort comparator)."""
    return (a < b) | (~torch.isnan(a) & torch.isnan(b))


def searchsorted_right(arr, q):
    """``jnp.searchsorted(arr, q, side="right")`` along the last axis, by
    the JAX package's own binary search: ceil(log2(N + 1)) halvings of
    [0, N], NaN sorting last. On an increasing ``arr`` it counts the
    entries <= q; on any other it gives JAX's answer. ``arr`` (..., N) and
    ``q`` (..., Q) broadcast in their leading axes."""
    n = arr.shape[-1]
    batch = torch.broadcast_shapes(arr.shape[:-1], q.shape[:-1])
    arr = arr.expand(*batch, n)
    q = q.expand(*batch, q.shape[-1])
    low = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    high = torch.full(q.shape, n, dtype=torch.int64, device=q.device)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = _lt_nan_last(q, torch.gather(arr, -1, mid))
        low, high = torch.where(go_left, low, mid), torch.where(go_left, mid,
                                                                high)
    return high


def _take(v, i):
    """v[..., i] for an index tensor i (..., Q) with broadcast batch axes."""
    batch = torch.broadcast_shapes(v.shape[:-1], i.shape[:-1])
    return torch.gather(v.expand(*batch, v.shape[-1]), -1,
                        i.expand(*batch, i.shape[-1]))


# ---------------------------------------------------------------------------
# PCHIP (Fritsch-Carlson monotone cubic Hermite)
# ---------------------------------------------------------------------------
def pchip_derivatives(x, y):
    """Monotone derivative estimates with scipy's endpoint rule. x, y:
    (..., N), broadcasting; returns d (..., N)."""
    h = torch.diff(x)
    delta = torch.diff(y) / h
    h_l, h_r = h[..., :-1], h[..., 1:]
    d_l, d_r = delta[..., :-1], delta[..., 1:]
    w1 = 2.0 * h_r + h_l
    w2 = h_r + 2.0 * h_l
    same_sign = (d_l * d_r) > 0.0
    one = torch.ones_like(d_l)
    denom = torch.where(same_sign,
                        w1 / torch.where(d_l == 0, one, d_l)
                        + w2 / torch.where(d_r == 0, one, d_r), one)
    d_int = torch.where(same_sign, (w1 + w2) / denom, torch.zeros_like(one))

    def edge(h0, h1, del0, del1):
        d = ((2.0 * h0 + h1) * del0 - h0 * del1) / (h0 + h1)
        d = torch.where(torch.sign(d) != torch.sign(del0),
                        torch.zeros_like(d), d)
        return torch.where((torch.sign(del0) != torch.sign(del1))
                           & (d.abs() > 3.0 * del0.abs()), 3.0 * del0, d)

    d0 = edge(h[..., 0], h[..., 1], delta[..., 0], delta[..., 1])
    dn = edge(h[..., -1], h[..., -2], delta[..., -1], delta[..., -2])
    batch = torch.broadcast_shapes(d0.shape, d_int.shape[:-1])
    return torch.cat([d0.expand(batch)[..., None],
                      d_int.expand(*batch, d_int.shape[-1]),
                      dn.expand(batch)[..., None]], dim=-1)


def _hermite(x, y, d, xq):
    i = torch.clamp(searchsorted_right(x, xq) - 1, 0, x.shape[-1] - 2)
    x0, x1 = _take(x, i), _take(x, i + 1)
    h = x1 - x0
    t = (xq - x0) / h
    return i, h, t


def pchip_eval(x, y, d, xq):
    """Evaluate the cubic Hermite defined by (x, y, d) at xq, extrapolating
    with the boundary pieces (scipy extrapolate=True)."""
    i, h, t = _hermite(x, y, d, xq)
    h00 = (1.0 + 2.0 * t) * (1.0 - t) ** 2
    h10 = t * (1.0 - t) ** 2
    h01 = t ** 2 * (3.0 - 2.0 * t)
    h11 = t ** 2 * (t - 1.0)
    return (h00 * _take(y, i) + h10 * h * _take(d, i) + h01 * _take(y, i + 1)
            + h11 * h * _take(d, i + 1))


def pchip_interp(x, y, xq, extrapolate=True):
    """One-shot monotone cubic interpolation; NaN outside if not
    ``extrapolate``."""
    out = pchip_eval(x, y, pchip_derivatives(x, y), xq)
    if not extrapolate:
        out = torch.where((xq < x[..., :1]) | (xq > x[..., -1:]),
                          torch.full_like(out, float("nan")), out)
    return out


def _compress_valid(x, y, valid, x_pad_step=1.0):
    """Gather the valid (x, y) points of each row to the front, in order;
    pad the tail with a strictly increasing x-ramp from the last valid x
    (step ``x_pad_step``, (...,) or a number) and the last valid y.

    Returns (xc, yc, n_valid)."""
    n = x.shape[-1]
    batch = torch.broadcast_shapes(x.shape, y.shape, valid.shape)
    x, y, valid = x.expand(batch), y.expand(batch), valid.expand(batch)
    order = torch.argsort(torch.where(valid, 0, 1), dim=-1, stable=True)
    xs, ys = torch.gather(x, -1, order), torch.gather(y, -1, order)
    vs = torch.gather(valid, -1, order)
    n_valid = valid.sum(-1)
    last = torch.clamp(n_valid - 1, min=0)[..., None]
    x_last, y_last = torch.gather(xs, -1, last), torch.gather(ys, -1, last)
    idx = torch.arange(n, device=x.device)
    step = torch.as_tensor(x_pad_step, dtype=x.dtype, device=x.device)
    if step.dim():
        step = step[..., None]
    ramp = x_last + (idx - last).to(x.dtype) * step
    return (torch.where(vs, xs, ramp), torch.where(vs, ys, y_last), n_valid)


def masked_pchip_interp(x, y, valid, xq, min_pts=5):
    """PCHIP through only the ``valid`` points of each row of (x, y),
    evaluated at ``xq``: NaN outside the valid x-range and NaN for the
    whole row when it has ``min_pts`` or fewer valid points (the JAX
    package's reading of the reference's broken-row rule)."""
    span = torch.clamp(x[..., -1] - x[..., 0], min=1.0)
    xc, yc, n_valid = _compress_valid(x, y, valid, x_pad_step=span)
    out = pchip_eval(xc, yc, pchip_derivatives(xc, yc), xq)
    last = torch.clamp(n_valid - 1, min=0)[..., None]
    in_range = (xq >= xc[..., :1]) & (xq <= torch.gather(xc, -1, last))
    ok = (n_valid[..., None] > min_pts) & in_range
    return torch.where(ok, out, torch.full_like(out, float("nan")))


# ---------------------------------------------------------------------------
# Not-a-knot cubic spline (CubicSpline and its derivative)
# ---------------------------------------------------------------------------
def spline_system(x, y):
    """The not-a-knot spline's tridiagonal system for the first derivatives
    at the knots of (x, y); x (N,), y (..., N). Returns (lower, main,
    upper, rhs) on y's device: the three diagonals (N,) with lower[0] =
    upper[-1] = 0, and rhs (..., N), in the JAX package's order of
    operations."""
    x = x.to(device=y.device, dtype=torch.float64)
    h = x[1:] - x[:-1]
    zero = h.new_zeros(1)
    main = torch.cat([h[1:2], 2.0 * (h[:-1] + h[1:]), h[-2:-1]])
    lower = torch.cat([zero, h[:-1], (h[-1] + h[-2])[None]])
    upper = torch.cat([(h[0] + h[1])[None], h[1:], zero])
    slope = (y[..., 1:] - y[..., :-1]) / h
    rhs_int = 3.0 * (slope[..., 1:] * h[:-1] + slope[..., :-1] * h[1:])
    rhs0 = ((h[0] + 2.0 * (h[0] + h[1])) * h[1] * slope[..., 0]
            + h[0] ** 2 * slope[..., 1]) / (h[0] + h[1])
    rhsn = (h[-1] ** 2 * slope[..., -2]
            + (2.0 * (h[-1] + h[-2]) + h[-1]) * h[-2] * slope[..., -1]) \
        / (h[-1] + h[-2])
    rhs = torch.cat([rhs0[..., None], rhs_int, rhsn[..., None]], dim=-1)
    return lower, main, upper, rhs


def cubic_spline_coeffs(x, y):
    """First derivatives at the knots of the not-a-knot cubic spline
    through (x, y); x (N,), y (..., N); a 1-D y gives (1, N). The system
    is built on y's device and solved by the Thomas algorithm, one knot
    after the other in float64 on the host, in the JAX package's order of
    operations. For a CUDA y this host sweep, copies included, was timed
    against the same sweep as launches on the card (~20x slower) and one
    dense ``torch.linalg.solve`` there (as fast alone, slower inside the
    profile that calls it): ``chip_smoke.py``'s ``spline_solves``,
    PERF.md."""
    lower, main, upper, rhs = spline_system(x, y)
    a, b, c = (t.cpu().numpy() for t in (lower, main, upper))
    n = b.size
    shape = (rhs.shape[:-1] or (1,)) + (n,)
    r = rhs.detach().reshape(-1, n).cpu().numpy().T           # (N, B)
    cps = np.empty(n)
    dps = np.empty_like(r)
    cp_prev, dp_prev = 0.0, np.zeros(r.shape[1])
    for i in range(n):
        denom = b[i] - a[i] * cp_prev
        cp_prev = c[i] / denom
        dp_prev = (r[i] - a[i] * dp_prev) / denom
        cps[i], dps[i] = cp_prev, dp_prev
    ds = np.empty_like(r)
    x_next = np.zeros(r.shape[1])
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        ds[i] = x_next
    return torch.as_tensor(np.ascontiguousarray(ds.T).reshape(shape),
                           device=y.device)


def _spline_segment(x, xq):
    i = torch.clamp(searchsorted_right(x, xq) - 1, 0, x.shape[0] - 2)
    h = x[i + 1] - x[i]
    return i, h, (xq - x[i]) / h


def cubic_spline_eval(x, y, d, xq):
    """Evaluate the Hermite-form spline; x (N,), y and d (..., N), xq
    (Q,)."""
    i, h, t = _spline_segment(x, xq)
    h00 = (1 + 2 * t) * (1 - t) ** 2
    h10 = t * (1 - t) ** 2
    h01 = t ** 2 * (3 - 2 * t)
    h11 = t ** 2 * (t - 1)
    return (h00 * y[..., i] + h10 * h * d[..., i] + h01 * y[..., i + 1]
            + h11 * h * d[..., i + 1])


def cubic_spline_derivative_eval(x, y, d, xq):
    """First derivative of the Hermite-form spline at xq."""
    i, h, t = _spline_segment(x, xq)
    dh00 = 6 * t * (t - 1) / h
    dh10 = (3 * t - 1) * (t - 1)
    dh01 = -6 * t * (t - 1) / h
    dh11 = t * (3 * t - 2)
    return (dh00 * y[..., i] + dh10 * d[..., i] + dh01 * y[..., i + 1]
            + dh11 * d[..., i + 1])


# ---------------------------------------------------------------------------
# Linear interpolation
# ---------------------------------------------------------------------------
def interp(x, xp, fp, left=None, right=None):
    """``jnp.interp(x, xp, fp, left, right)`` (and so ``np.interp`` on an
    increasing ``xp``), with jnp's arithmetic. xp is 1-D (N,), x any shape;
    fp is (..., N), a batch of rows sharing xp, and the result is
    (..., *x.shape). ``left``/``right`` default to fp's end values."""
    shape = x.shape
    xr = x.reshape(-1)
    n = xp.shape[0]
    i = torch.clamp(searchsorted_right(xp[None, :], xr[None, :])[0], 1,
                    n - 1)
    df = fp[..., i] - fp[..., i - 1]
    dx = xp[i] - xp[i - 1]
    delta = xr - xp[i - 1]
    eps = float(np.spacing(np.finfo(
        np.float64 if xp.dtype == torch.float64 else np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[..., i - 1],
                    fp[..., i - 1]
                    + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    lv = fp[..., :1] if left is None else torch.as_tensor(
        left, dtype=f.dtype, device=f.device)
    rv = fp[..., -1:] if right is None else torch.as_tensor(
        right, dtype=f.dtype, device=f.device)
    f = torch.where(xr < xp[0], lv, f)
    f = torch.where(xr > xp[-1], rv, f)
    return f.reshape(fp.shape[:-1] + shape)


def interp1d_linear(x, y, xq, left=None, right=None):
    """Linear interpolation of (x, y) at xq (``np.interp``'s defaults)."""
    return interp(xq, x, y, left=left, right=right)


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


def halo_corners_plain(table, axes, r_axis, M, a, p_keys, kwargs):
    """Plain version of K1's per-halo step, formed once a halo. Returns
    each corner's weight (n, 2^D), built axis by axis as w = w * (bit ? t
    : 1 - t); the flat offset (n, 2^D) of its row in the contiguous (z,
    M, r, p...) table at radius 0 (radius r adds r times ``stride_r``);
    ``stride_r``; and the out-of-table flag (n,). Summing w times the rows
    over the corners in order gives :func:`collapse_curves_plain`'s curves
    bit for bit."""
    dt, dev = table.dtype, table.device
    M_use, a_use = _halo_columns(table, M, a)
    n = M_use.numel()
    vals = [torch.log(1.0 / a_use).expand(n), torch.log(M_use)]
    for k in p_keys:
        vals.append(torch.as_tensor(kwargs[k], dtype=dt,
                                    device=dev).expand(n))
    axis_ids = [0, 1] + list(range(r_axis + 1, table.dim()))
    stride = table.contiguous().stride()
    locs = [_locate(axes[ai], v.contiguous())
            for ai, v in zip(axis_ids, vals)]
    oob = torch.zeros(n, dtype=torch.bool, device=dev)
    for _, _, o in locs:
        oob = oob | o
    w, off = [], []
    for corner in range(2 ** len(locs)):
        wc = torch.ones((n,), dtype=dt, device=dev)
        oc = torch.zeros((n,), dtype=torch.int64, device=dev)
        for d, (i, t, _) in enumerate(locs):
            bit = (corner >> d) & 1
            wc = wc * (t if bit else 1.0 - t)
            oc = oc + (i + bit) * stride[axis_ids[d]]
        w.append(wc)
        off.append(oc)
    return torch.stack(w, 1), torch.stack(off, 1), stride[r_axis], oob


class _CurveAxes(ctypes.Structure):
    """csrc/curves.cu: CurveAxes, a table's axes (built once a table)."""
    _fields_ = [("grid", ctypes.c_void_p * (2 + MAX_P_AXES)),
                ("size", ctypes.c_int * (2 + MAX_P_AXES)),
                ("n", ctypes.c_int), ("nr", ctypes.c_int)]


class _CurveHalos(ctypes.Structure):
    """csrc/curves.cu: CurveHalos, a call's halo columns."""
    _fields_ = [("col", ctypes.c_void_p * (2 + MAX_P_AXES)),
                ("step", ctypes.c_int * (2 + MAX_P_AXES)),
                ("f64", ctypes.c_int * (2 + MAX_P_AXES)),
                ("val", ctypes.c_double * (2 + MAX_P_AXES))]


class CurveTable:
    """A (z, M, r, p...) table set up for the curve collapse once: checked,
    K1's axis pointers and sizes in its ``CurveAxes``, and (ln_r0, dlnr)
    taken as floats from a host copy of the radial axis (``ln_r``, when
    given), so that a call (:meth:`collapse`) makes one launch and no
    device sync. Columns on the
    card are read as they are (float64 or the table's type); host columns
    go up as float64 through pinned memory in one asynchronous copy. The
    kernel rounds float64 values to the table's type. The model classes
    keep theirs (:func:`curve_table`). A table on the CPU runs the plain
    version."""

    def __init__(self, table, axes, r_axis, p_keys, ln_r=None):
        self.table, self.axes, self.p_keys = table, axes, list(p_keys)
        self.r_axis = r_axis
        ln_r = (axes[r_axis] if ln_r is None else ln_r).detach().cpu()
        self.ln_r0 = float(ln_r[0])
        self.dlnr = float(ln_r[1] - ln_r[0])
        if table.device.type == "cpu":
            return
        if table.device.type != "cuda":
            raise ValueError(
                f"collapse_curves: unsupported device {table.device}")
        if r_axis != 2 or table.dim() != 3 + len(p_keys):
            raise ValueError("collapse_curves: the table must be (z, M, r, "
                             "p...) with one trailing axis per p_key")
        if len(p_keys) > MAX_P_AXES:
            raise NotImplementedError(
                f"collapse_curves on CUDA: {len(p_keys)} parameter axes; "
                f"the kernel keeps each axis' bracket on a lane and takes at"
                f" most {MAX_P_AXES}")
        dt = table.dtype
        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"collapse_curves: unsupported dtype {dt}")
        if len(axes) != table.dim():
            raise ValueError("collapse_curves: one axis grid per table axis")
        for d, x in enumerate(axes):
            if x.dtype != dt or x.device != table.device or x.dim() != 1:
                raise ValueError(f"collapse_curves: axis {d} must be a 1-D "
                                 f"{dt} tensor on {table.device}")
            if x.numel() != table.shape[d]:
                raise ValueError("collapse_curves: axes do not match the "
                                 "table")
            if x.numel() < 2:
                raise ValueError("collapse_curves: every axis needs >= 2 "
                                 "points")
        if table.numel() >= 2 ** 31:
            raise ValueError("collapse_curves: the table holds 2^31 values "
                             "or more (int32 index math)")
        self._table = table.contiguous()
        self._grids = [axes[d].contiguous()
                       for d in [0, 1] + list(range(3, table.dim()))]
        self._axes_c = _CurveAxes()
        for d, g in enumerate(self._grids):
            self._axes_c.grid[d] = g.data_ptr()
            self._axes_c.size[d] = g.numel()
        self._axes_c.n = len(self._grids)
        self._axes_c.nr = table.shape[r_axis]
        self._halos_c = _CurveHalos()
        self._device = table.device.index
        lib = _build.library()
        self._fn = (lib.bf_collapse_curves_f32 if dt == torch.float32
                    else lib.bf_collapse_curves_f64)

    def collapse(self, M, a, kwargs, fill=0.0):
        """Per-halo curves (n, N_r) for masses ``M`` (scalar or (n,)) at
        scale factors ``a`` and parameters ``kwargs[p]`` (each a scalar or
        (n,); on the host or on the table's device), with (ln_r0, dlnr) as
        floats. Host columns go up in one copy, a scalar by value, and a
        column on the card is read in place."""
        for k in self.p_keys:
            if k not in kwargs:
                raise ValueError(f"need {k} as input (table built with it)")
        values = [a, M] + [kwargs[k] for k in self.p_keys]
        n = _size(M)
        for v in values:
            if _size(v) not in (1, n):
                raise ValueError(f"collapse_curves: {_size(v)} values of an "
                                 f"axis for {n} halos")
        if self.table.device.type == "cpu":
            curves = collapse_curves_plain(self.table, self.axes, self.r_axis,
                                           M, a, self.p_keys, kwargs, fill)[0]
            return curves, self.ln_r0, self.dlnr
        table = self._table
        dt, dev = table.dtype, table.device
        nr = self._axes_c.nr
        if n * nr >= 2 ** 31:
            raise ValueError("collapse_curves: n_halos x n_r must stay "
                             "below 2^31 (int32 index math)")
        hs = self._halos_c
        host, keep = [], []
        for d, v in enumerate(values):
            if isinstance(v, torch.Tensor) and v.device.type != "cpu":
                if v.device != dev:
                    raise ValueError(f"collapse_curves: halo values on "
                                     f"{v.device}, table on {dev}")
                if (v.dtype not in (dt, torch.float64) or v.dim() != 1
                        or not v.is_contiguous()):
                    v = v.detach().reshape(-1).to(dt).contiguous()
                    keep.append(v)
                hs.col[d] = v.data_ptr()
                hs.step[d] = int(v.numel() > 1)
                hs.f64[d] = int(v.dtype == torch.float64)
                continue
            if isinstance(v, torch.Tensor):
                v = v.detach()
            arr = np.asarray(v, dtype=np.float64).reshape(-1)
            if arr.size == 1:
                hs.col[d] = None
                hs.val[d] = float(arr[0])
            else:
                host.append((d, arr))
        if host:
            keep.append(self._upload(host, n))
        out = torch.empty((n, nr), dtype=dt, device=dev)
        if n:
            if torch.cuda.current_device() != self._device:
                with torch.cuda.device(dev):
                    err = self._launch(n, fill, out)
            else:
                err = self._launch(n, fill, out)
            _build.check(err, "collapse_curves")
            _build.launches["collapse_curves"] += 1
        return out, self.ln_r0, self.dlnr

    def _launch(self, n, fill, out):
        return self._fn(self._table.data_ptr(), ctypes.addressof(self._axes_c),
                        ctypes.addressof(self._halos_c), n, fill,
                        out.data_ptr(),
                        torch._C._cuda_getCurrentRawStream(self._device))

    def _upload(self, host, n):
        """The host columns ``host`` ((axis, float64 array) pairs) put in
        pinned memory and copied up in one asynchronous copy (PyTorch's
        pinned allocator keeps the host buffer until the copy is done);
        their columns set in CurveHalos. Returns the device buffer."""
        pinned = torch.empty((len(host), n), dtype=torch.float64,
                             pin_memory=True)
        staged = pinned.numpy()
        for j, (_, arr) in enumerate(host):
            staged[j] = arr
        buf = pinned.to(self._table.device, non_blocking=True)
        hs = self._halos_c
        for j, (d, _) in enumerate(host):
            hs.col[d] = buf.data_ptr() + 8 * j * n
            hs.step[d] = 1
            hs.f64[d] = 1
        return buf


def _size(v):
    return v.numel() if isinstance(v, torch.Tensor) else int(np.size(v))


def cast_copy(model, names, dtype, device):
    """A shallow copy of ``model`` with its tensors ``names`` (attributes: a
    tensor or a tuple of tensors, ``_axes`` among them) cast to ``dtype``
    on ``device``. The casts are kept on the model, one set a (dtype,
    device), with the K1 set-ups made on them (:func:`curve_table`), and
    made anew once any of those attributes is another object (a table
    rebuilt by ``setup_interpolator`` or ``load_table``)."""
    casts = model.__dict__.setdefault("_casts", {})
    src = {k: getattr(model, k) for k in names}
    hit = casts.get((dtype, device))
    if hit is None or any(v is not hit[0][k] for k, v in src.items()):
        cast = {k: tuple(x.to(device=device, dtype=dtype) for x in v)
                if isinstance(v, tuple) else v.to(device=device, dtype=dtype)
                for k, v in src.items()}
        hit = casts[(dtype, device)] = (src, cast, {})
    new = copy.copy(model)
    new.__dict__.update(hit[1])
    return new


def curve_table(model, name):
    """The :class:`CurveTable` of ``model``'s table ``name`` (radial axis
    at 2, axes ``model._axes``). On a copy made by :func:`cast_copy` it is
    the one kept with the casts, built at its first call with (ln_r0,
    dlnr) from the model's own radial axis; otherwise (the models' own
    tables, float64 on the CPU, where the set-up is the plain version's)
    it is set up anew."""
    table, axes = getattr(model, name), model._axes
    for src, cast, tables in model.__dict__.get("_casts", {}).values():
        if cast.get(name) is table and cast.get("_axes") is axes:
            if name not in tables:
                tables[name] = CurveTable(table, axes, 2, model.p_keys,
                                          ln_r=src["_axes"][2].to(table.dtype))
            return tables[name]
    return CurveTable(table, axes, 2, model.p_keys)


def collapse_curves(table, axes, r_axis, M, a, p_keys, kwargs, fill=0.0):
    """Per-halo curve collapse: kernel K1 for a table on CUDA, the plain
    version for a table on the CPU. Same arguments as
    :func:`collapse_curves_plain`; returns (curves, ln_r0, dlnr) with the
    last two as floats. Sets the table up anew (:class:`CurveTable`); the
    model classes keep theirs.

    The kernel takes float32 or float64 (z, M, r, p1, ...) tables with the
    radial axis at index 2 and at most ``MAX_P_AXES`` parameter axes.
    """
    return CurveTable(table, axes, r_axis, p_keys).collapse(M, a, kwargs,
                                                            fill)
