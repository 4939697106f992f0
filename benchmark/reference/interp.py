"""Interpolation: PCHIP, masked PCHIP, cubic splines, linear and
multilinear interpolation, and the per-halo curve collapse.

A frozen copy of the plain (CPU) version in ``baryonforge_torch/ops/interp.py`` at
the commit that added the benchmark, with the kernel wrappers left out, so
that it runs in plain PyTorch on any device. It is the benchmark's
reference: it imports nothing of the program and is not edited with it.
"""

import math

import numpy as np
import torch


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
    at the knots of (x, y); x (..., N) (one knot vector, or one a row), y
    (..., N). Returns (lower, main, upper, rhs) on y's device: the three
    diagonals (..., N) of x's shape with lower[..., 0] = upper[..., -1] =
    0, and rhs (..., N), in the JAX package's order of operations."""
    x = x.to(device=y.device, dtype=torch.float64)
    h = x[..., 1:] - x[..., :-1]
    zero = h.new_zeros(h.shape[:-1] + (1,))
    main = torch.cat([h[..., 1:2], 2.0 * (h[..., :-1] + h[..., 1:]),
                      h[..., -2:-1]], dim=-1)
    lower = torch.cat([zero, h[..., :-1], h[..., -1:] + h[..., -2:-1]],
                      dim=-1)
    upper = torch.cat([h[..., :1] + h[..., 1:2], h[..., 1:], zero], dim=-1)
    h0, h1, hn, hm = h[..., 0], h[..., 1], h[..., -1], h[..., -2]
    slope = (y[..., 1:] - y[..., :-1]) / h
    rhs_int = 3.0 * (slope[..., 1:] * h[..., :-1]
                     + slope[..., :-1] * h[..., 1:])
    rhs0 = ((h0 + 2.0 * (h0 + h1)) * h1 * slope[..., 0]
            + h0 ** 2 * slope[..., 1]) / (h0 + h1)
    rhsn = (hn ** 2 * slope[..., -2]
            + (2.0 * (hn + hm) + hn) * hm * slope[..., -1]) / (hn + hm)
    rhs = torch.cat([rhs0[..., None], rhs_int, rhsn[..., None]], dim=-1)
    return lower, main, upper, rhs


def cubic_spline_coeffs(x, y):
    """First derivatives at the knots of the not-a-knot cubic spline
    through (x, y); x (N,), or (..., N) with knots of their own a row (the
    JAX package's vmap over rows), y (..., N); a 1-D y gives (1, N). The
    system is built on y's device and solved by the Thomas algorithm, one
    knot after the other in float64 on the host, in the JAX package's order
    of operations (rows with knots of their own are swept side by side).
    For a CUDA y this host sweep, copies included, was timed against the
    same sweep as launches on the card (~20x slower) and one dense
    ``torch.linalg.solve`` there (as fast alone, slower inside the profile
    that calls it): ``chip_smoke.py``'s ``spline_solves``, PERF.md."""
    lower, main, upper, rhs = spline_system(x, y)
    n = main.shape[-1]
    shape = (rhs.shape[:-1] or (1,)) + (n,)
    r = rhs.detach().reshape(-1, n).cpu().numpy().T           # (N, B)
    if main.dim() == 1:                 # shared knots: scalar diagonals
        a, b, c = (t.cpu().numpy() for t in (lower, main, upper))
        cp_prev = 0.0
    else:                               # (N, B) beside r's rows
        a, b, c = (t.detach().expand(rhs.shape).reshape(-1, n).cpu()
                   .numpy().T for t in (lower, main, upper))
        cp_prev = np.zeros(r.shape[1])
    cps = np.empty(b.shape)
    dps = np.empty_like(r)
    dp_prev = np.zeros(r.shape[1])
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
    i = torch.clamp(searchsorted_right(x, xq) - 1, 0, x.shape[-1] - 2)
    x0 = _take(x, i)
    h = _take(x, i + 1) - x0
    return i, h, (xq - x0) / h


def cubic_spline_eval(x, y, d, xq):
    """Evaluate the Hermite-form spline; x (N,) or (..., N) a row each, y
    and d (..., N), xq (Q,) or (..., Q)."""
    i, h, t = _spline_segment(x, xq)
    h00 = (1 + 2 * t) * (1 - t) ** 2
    h10 = t * (1 - t) ** 2
    h01 = t ** 2 * (3 - 2 * t)
    h11 = t ** 2 * (t - 1)
    return (h00 * _take(y, i) + h10 * h * _take(d, i)
            + h01 * _take(y, i + 1) + h11 * h * _take(d, i + 1))


def cubic_spline_derivative_eval(x, y, d, xq):
    """First derivative of the Hermite-form spline at xq."""
    i, h, t = _spline_segment(x, xq)
    dh00 = 6 * t * (t - 1) / h
    dh10 = (3 * t - 1) * (t - 1)
    dh01 = -6 * t * (t - 1) / h
    dh11 = t * (3 * t - 2)
    return (dh00 * _take(y, i) + dh10 * _take(d, i)
            + dh01 * _take(y, i + 1) + dh11 * _take(d, i + 1))


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


def _locate(ax, x):
    """Bracketing index (searchsorted side="right", minus one, clamped to
    [0, n-2]), the fraction inside the bracket, and out-of-range flags."""
    i = torch.clamp(torch.searchsorted(ax, x, right=True) - 1,
                    0, ax.shape[0] - 2)
    t = (x - ax[i]) / (ax[i + 1] - ax[i])
    oob = (x < ax[0]) | (x > ax[-1])
    return i, t, oob


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
