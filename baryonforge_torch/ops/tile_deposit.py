"""Tiled phase A: the per-tile (slot, halo) pair deposit of tangent-angle
offsets, and the tiled paint.

``tile_deposit`` is the wrapper of kernel K4 (``csrc/tile_deposit.cu``);
``tile_deposit_plain`` is its plain version, a port of
``baryonforge_tpu.ops.tiles.make_tile_deposit(mode="displace")`` (its
``one_tile``, tiles.py:846-1029) with the direct lerp of the curve that
the JAX package takes off the TPU (tiles.py:967-971). The hat-basis sweep,
its window classes and the padded static buckets are TPU workarounds and
are not ported: each touched tile takes its halos from a CSR list
(``ops.tiles.pairs_csr``).

For every pair, in the deposit dtype: the chord from tile-local
coordinates (subtract, then square), ln r = ln chord + lnDa, the curve's
lerp at x = (ln r - ln_r0) / dlnr, the mask chord^2 <= crit2 and x on the
curve, amp = d * afac / (chord D); per slot the split sums
s0 = sum amp, sth = sum amp (dh . e_th), sph = sum amp (dh . e_ph), and
out = (s0 a_th - sth, s0 a_ph - sph). Dead slots and non-finite values
are exact zeros: the stencil regrid reads neighbouring tiles' storage.
K4 writes every tile, touched or not, so its accumulator needs no clearing
beforehand. It forms each (tile, ring row)'s float64 values once a row and
each slot's from them (``slot_geometry_plain`` is the plain version of
that layout, equal to ``SkyTiling.slot_local(tangent=True)``), and wraps
the slot's azimuth offset by the exact remainder
(``ops.healpix.floor_fmod_near``).

``tile_paint`` is the wrapper of kernel K10 (K4's kernel in paint mode,
entry point ``bf_tile_paint``); ``tile_paint_plain`` is its plain version,
a port of ``make_tile_deposit(mode="paint")`` with the direct lerp: per
pair the same chord, x and mask, then exp of the lerp for log curves,
d = (use ? value : 0) afac, summed per slot into a (n_tiles, RB*K) map.

``tile_paint2`` is the wrapper of kernel K12 (the same kernel in paint2
mode, entry point ``bf_tile_paint2``); ``tile_paint2_plain`` is its plain
version, a port of ``make_tile_deposit(mode="paint2")`` with the direct
lerp: per pair the chord, ln r and the first curve's x and mask as above,
the second curve's lerp at x2 = (ln r - ln_r0_2) inv_dlnr_2 on its own
grid, the pair used only when x2 lies on that grid too, and the value
exp(v1 + v2) for two log curves, else v1 v2.
"""

import math

import torch

from . import _build
from . import healpix as hpx

__all__ = ["tile_deposit", "tile_deposit_plain", "tile_paint",
           "tile_paint_plain", "tile_paint2", "tile_paint2_plain",
           "row_geometry_plain", "slot_geometry_plain", "PACK_KEYS",
           "PAINT_KEYS", "PAINT2_KEYS"]

_TWO_PI = 2.0 * math.pi

# per-halo columns: vh (n, 3) float64 unit vectors; the rest in the
# deposit dtype: crit2 = (2 sin(min(radius, pi)/2))^2, lnDa = ln(D/a) +
# ln(rscale), invD = 1/D, afac = a, curves (n, n_r)
PACK_KEYS = ("vh", "crit2", "lnDa", "invD", "afac", "curves")
# the paint's columns: lnDa = ln(D/a), afac the per-halo paint scale (1/a,
# times pixarea D^2 for a per-pixel integral), curves the paint curves
PAINT_KEYS = ("vh", "crit2", "lnDa", "afac", "curves")
# paint2's columns: PAINT_KEYS with afac the per-halo scale of the product
# (1/a^2, times pixarea D^2 for a per-pixel integral) and curves2 (n, n_r2)
# the second curve, on its own grid
PAINT2_KEYS = PAINT_KEYS + ("curves2",)

# tiles and pairs per step of the plain version
_TILE_CHUNK = 1024
_PAIR_CHUNK = 2048
# the kernel's shared memory a block: one row of ring values takes at
# most 64 bytes, a staged halo 7 + n_r values (+ n_r2 for paint2)
_ROW_BYTES = 64
_SMEM = 48 * 1024 - 16


def _check(tiling, csr, pack, keys=PACK_KEYS, name="tile_deposit"):
    curves = pack["curves"]
    dt, dev = curves.dtype, curves.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported dtype {dt}")
    if curves.dim() != 2 or curves.shape[1] < 2:
        raise ValueError(f"{name}: curves must be (n_halos, n_r >= 2)")
    n = curves.shape[0]
    if "curves2" in keys and (pack["curves2"].dim() != 2
                              or pack["curves2"].shape[1] < 2):
        raise ValueError(f"{name}: curves2 must be (n_halos, n_r2 >= 2)")
    for k in keys:
        x = pack[k]
        want = ((n, 3), torch.float64) if k == "vh" else (
            (n, x.shape[-1]) if k.startswith("curves") else (n,), dt)
        if tuple(x.shape) != want[0] or x.dtype != want[1] \
                or x.device != dev:
            raise ValueError(f"{name}: pack[{k!r}] must be a "
                             f"{want[1]} {want[0]} tensor on {dev}")
    tiles, offsets, halos = csr
    for cname, x in (("tiles", tiles), ("offsets", offsets),
                     ("halos", halos)):
        if x.dtype != torch.int32 or x.dim() != 1 or x.device != dev:
            raise ValueError(f"{name}: {cname} must be a 1-D int32 "
                             f"tensor on {dev}")
    if offsets.numel() != tiles.numel() + 1:
        raise ValueError(f"{name}: need len(offsets) == len(tiles) + 1")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda":
        n_pts = sum(pack[k].shape[1] for k in keys if k.startswith("curves"))
        if ((7 + n_pts) * curves.element_size() + tiling.RB * _ROW_BYTES
                > _SMEM):
            raise ValueError(f"{name}: curves of {n_pts} points do not fit "
                             "the kernel's 48 KB of shared memory for one "
                             "halo beside the tile's rows")


def row_geometry_plain(tiling, tids):
    """Plain version of K4's per-row layout (csrc/tile_deposit.cu: Row,
    row_geometry): for int64 tile ids ``tids`` (T,), each (tile, ring row)'s
    values as the kernel forms them once a row, (T, RB) each: ``ok`` (ring
    on the sphere), ``len`` (int32 segment length), ``jb`` = j0 + sh / 2
    (the segment start and shift, exact), ``dphi`` = 2 pi / nr and sin/cos
    of the ring's colatitude, ``sth``, ``cth``, and minus the tile
    centre's, ``dsin``, ``dcos`` (float64)."""
    arr = tiling.device_arrays(tids.device)
    ring_ok, i_c, _, nr, sh, j0, j1 = tiling._segments(
        arr["tile_i0"][tids], arr["tile_s"][tids], arr["tile_S"][tids])
    csc = arr["csc"][tids]
    theta_r = hpx.ring_theta(tiling.nside, i_c, torch.float64)
    sth, cth = torch.sin(theta_r), torch.cos(theta_r)
    return dict(ok=ring_ok, len=j1 - j0, jb=j0.double() + 0.5 * sh,
                dphi=_TWO_PI / nr.double(), sth=sth, cth=cth,
                dsin=sth - csc[:, 0:1], dcos=cth - csc[:, 1:2])


def slot_geometry_plain(tiling, tids, dtype):
    """Plain version of K4's slot geometry (csrc/tile_deposit.cu:
    slot_geometry) from :func:`row_geometry_plain`'s rows: each slot's
    azimuth offset in float64, wrapped by the exact remainder, then the
    tile-local quantities in ``dtype``. Returns, as
    ``SkyTiling.slot_local(..., tangent=True)``: dp (T, 3, P), valid (T,
    RB, K), e_th, e_ph (T, 3, P), a_th, a_ph (T, P)."""
    r = row_geometry_plain(tiling, tids)
    T, P = tids.numel(), tiling.P
    csc = tiling.device_arrays(tids.device)["csc"][tids]
    v = torch.arange(tiling.K, dtype=torch.int32, device=tids.device)
    valid = r["ok"][:, :, None] & (v < r["len"][:, :, None])
    d = ((v.double() + r["jb"][:, :, None]) * r["dphi"][:, :, None]
         - csc[:, 4, None, None])
    d = hpx.floor_fmod_near(d + math.pi, _TWO_PI) - math.pi
    d32 = d.to(dtype)
    s2 = torch.sin(0.5 * d32)
    c2 = torch.cos(0.5 * d32)
    sind = 2.0 * s2 * c2
    cosm1 = -2.0 * s2 * s2
    dsin, dcos, sth, cth = (r[k].to(dtype)[:, :, None]
                            for k in ("dsin", "dcos", "sth", "cth"))
    A = dsin + sth * cosm1
    B = sth * sind
    sphc, cphc = (csc[:, k, None, None].to(dtype) for k in (2, 3))
    dp = torch.stack([cphc * A - sphc * B, sphc * A + cphc * B,
                      dcos.expand(A.shape)], dim=1).reshape(T, 3, P)
    cosd = 1.0 + cosm1
    sinp = sphc * cosd + cphc * sind
    cosp = cphc * cosd - sphc * sind
    e_th = torch.stack([cth * cosp, cth * sinp, (-sth).expand(A.shape)],
                       dim=1).reshape(T, 3, P)
    e_ph = torch.stack([-sinp, cosp, torch.zeros_like(sinp)],
                       dim=1).reshape(T, 3, P)
    a_th = dp[:, 0] * e_th[:, 0] + dp[:, 1] * e_th[:, 1] \
        + dp[:, 2] * e_th[:, 2]
    a_ph = dp[:, 0] * e_ph[:, 0] + dp[:, 1] * e_ph[:, 1] \
        + dp[:, 2] * e_ph[:, 2]
    return dp, valid, e_th, e_ph, a_th, a_ph


def _chunks(tiling, csr, dt, tangent):
    """The plain versions' work, per chunk of touched tiles: their ids,
    their slot geometry (``SkyTiling.slot_local``) and centres in ``dt``,
    and their pairs in chunks of (local tile index, halo id)."""
    tiles, offsets, halos = csr
    dev = tiles.device
    arr = tiling.device_arrays(dev)
    offs = offsets.cpu().tolist()
    pair_tile = torch.repeat_interleave(
        torch.arange(tiles.numel(), device=dev),
        (offsets[1:] - offsets[:-1]).long())
    for t0 in range(0, tiles.numel(), _TILE_CHUNK):
        t1 = min(t0 + _TILE_CHUNK, tiles.numel())
        tid = tiles[t0:t1].long()
        geo = tiling.slot_local(arr["tile_i0"][tid], arr["tile_s"][tid],
                                arr["tile_S"][tid], arr["csc"][tid], dt,
                                tangent=tangent)
        pairs = []
        for q0 in range(offs[t0], offs[t1], _PAIR_CHUNK):
            q1 = min(q0 + _PAIR_CHUNK, offs[t1])
            pairs.append((pair_tile[q0:q1] - t0, halos[q0:q1].long()))
        yield tid, geo, arr["center"][tid].to(dt), pairs


def _lerp(curves, h, x):
    """The lerp of halos ``h``'s curves at x (truncated bracket, clamped to
    the grid) and the mask of x on the grid."""
    n_r = curves.shape[1]
    i = torch.clamp(x.to(torch.int32), 0, n_r - 2)
    t = x - i.to(x.dtype)
    cv = curves[h]
    il = i.long()
    val = (torch.gather(cv, 1, il) * (1.0 - t)
           + torch.gather(cv, 1, il + 1) * t)
    return val, (x >= 0) & (x <= n_r - 1)


def _pair_lookup(dh, dpp, pack, h, ln_r0, inv_dlnr):
    """The chord^2, ln r, curve lerp and mask of a chunk of (pair, slot):
    dh (n, 3) the halos' offsets from their tiles' centres, dpp (n, 3, P)
    the slots'."""
    d0 = dh[:, 0:1] - dpp[:, 0]
    d1 = dh[:, 1:2] - dpp[:, 1]
    d2 = dh[:, 2:3] - dpp[:, 2]
    chord2 = d0 * d0 + d1 * d1 + d2 * d2
    chord2 = torch.clamp(chord2, min=1e-30)
    lnr = 0.5 * torch.log(chord2) + pack["lnDa"][h][:, None]
    val, on_grid = _lerp(pack["curves"], h, (lnr - ln_r0) * inv_dlnr)
    use = on_grid & (chord2 <= pack["crit2"][h][:, None])
    return chord2, lnr, val, use


def _finish(out, valid):
    """Dead slots and non-finite values as exact zeros."""
    out = torch.where(valid, out, torch.zeros_like(out))
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def tile_deposit_plain(tiling, csr, pack, ln_r0, inv_dlnr):
    """Plain version of K4, in tile and pair chunks. Arguments as
    :func:`tile_deposit`."""
    dt, dev = pack["curves"].dtype, pack["curves"].device
    P = tiling.P
    acc = torch.zeros((tiling.n_tiles, P, 2), dtype=dt, device=dev)
    for tid, geo, c, pairs in _chunks(tiling, csr, dt, tangent=True):
        dp, valid, e_th, e_ph, a_th, a_ph = geo
        s0 = torch.zeros((tid.numel(), P), dtype=dt, device=dev)
        sth = torch.zeros_like(s0)
        sph = torch.zeros_like(s0)
        for lt, h in pairs:
            dh = pack["vh"][h].to(dt) - c[lt]                    # (n, 3)
            chord2, _, val, use = _pair_lookup(dh, dp[lt], pack, h, ln_r0,
                                               inv_dlnr)
            d = torch.where(use, val, torch.zeros_like(val)) \
                * pack["afac"][h][:, None]
            amp = d * torch.rsqrt(chord2) * pack["invD"][h][:, None]
            eth, eph = e_th[lt], e_ph[lt]
            gth = (dh[:, 0:1] * eth[:, 0] + dh[:, 1:2] * eth[:, 1]
                   + dh[:, 2:3] * eth[:, 2])
            gph = (dh[:, 0:1] * eph[:, 0] + dh[:, 1:2] * eph[:, 1]
                   + dh[:, 2:3] * eph[:, 2])
            s0.index_add_(0, lt, amp)
            sth.index_add_(0, lt, amp * gth)
            sph.index_add_(0, lt, amp * gph)
        out = torch.stack([s0 * a_th - sth, s0 * a_ph - sph], dim=-1)
        acc[tid] = _finish(out, valid.reshape(tid.numel(), P, 1))
    return acc


def tile_paint_plain(tiling, csr, pack, ln_r0, inv_dlnr, log_curves):
    """Plain version of K10, in tile and pair chunks. Arguments as
    :func:`tile_paint`."""
    dt, dev = pack["curves"].dtype, pack["curves"].device
    P = tiling.P
    acc = torch.zeros((tiling.n_tiles, P), dtype=dt, device=dev)
    for tid, (dp, valid), c, pairs in _chunks(tiling, csr, dt,
                                              tangent=False):
        s0 = torch.zeros((tid.numel(), P), dtype=dt, device=dev)
        for lt, h in pairs:
            dh = pack["vh"][h].to(dt) - c[lt]
            _, _, val, use = _pair_lookup(dh, dp[lt], pack, h, ln_r0,
                                          inv_dlnr)
            if log_curves:
                val = torch.exp(val)
            s0.index_add_(0, lt, torch.where(use, val, torch.zeros_like(val))
                          * pack["afac"][h][:, None])
        acc[tid] = _finish(s0, valid.reshape(tid.numel(), P))
    return acc


def tile_paint2_plain(tiling, csr, pack, ln_r0, inv_dlnr, ln_r0_2,
                      inv_dlnr_2, log_curves):
    """Plain version of K12, in tile and pair chunks. Arguments as
    :func:`tile_paint2`."""
    dt, dev = pack["curves"].dtype, pack["curves"].device
    P = tiling.P
    acc = torch.zeros((tiling.n_tiles, P), dtype=dt, device=dev)
    for tid, (dp, valid), c, pairs in _chunks(tiling, csr, dt,
                                              tangent=False):
        s0 = torch.zeros((tid.numel(), P), dtype=dt, device=dev)
        for lt, h in pairs:
            dh = pack["vh"][h].to(dt) - c[lt]
            _, lnr, val, use = _pair_lookup(dh, dp[lt], pack, h, ln_r0,
                                            inv_dlnr)
            v2, on2 = _lerp(pack["curves2"], h, (lnr - ln_r0_2) * inv_dlnr_2)
            val = torch.exp(val + v2) if log_curves else val * v2
            s0.index_add_(0, lt, torch.where(use & on2, val,
                                             torch.zeros_like(val))
                          * pack["afac"][h][:, None])
        acc[tid] = _finish(s0, valid.reshape(tid.numel(), P))
    return acc


def tile_deposit(tiling, csr, pack, ln_r0, inv_dlnr):
    """Deposit every (tile, halo) pair's tangent displacement on the
    tile's slots.

    tiling   : ops.tiles.SkyTiling
    csr      : (tiles, offsets, halos) int32 tensors from
               ``ops.tiles.pairs_csr``: the touched tiles and each one's
               halo ids
    pack     : dict of per-halo tensors, ``PACK_KEYS``; the curves' dtype
               (float32 or float64) is the deposit dtype
    ln_r0, inv_dlnr : the curve grid ln r = ln_r0 + x / inv_dlnr (floats,
               used in the deposit dtype)

    Returns the tile-major (n_tiles, RB*K, 2) accumulator of (d theta,
    sin theta d phi); untouched tiles are zero. Kernel K4 for tensors on
    CUDA, the plain version for tensors on the CPU.
    """
    _check(tiling, csr, pack)
    if pack["curves"].device.type == "cpu":
        return tile_deposit_plain(tiling, csr, pack, float(ln_r0),
                                  float(inv_dlnr))
    acc = torch.empty((tiling.n_tiles, tiling.P, 2),
                      dtype=pack["curves"].dtype, device=pack["curves"].device)
    _launch("tile_deposit", tiling, csr, pack, PACK_KEYS, ln_r0, inv_dlnr,
            (), acc)
    return acc


def tile_paint(tiling, csr, pack, ln_r0, inv_dlnr, log_curves):
    """Paint every (tile, halo) pair's curve value on the tile's slots.

    tiling, csr, ln_r0, inv_dlnr : as :func:`tile_deposit`
    pack       : dict of per-halo tensors, ``PAINT_KEYS``; the curves' dtype
                 (float32 or float64) is the paint's dtype
    log_curves : the curves hold logs (TabulatedProfile), exponentiated
                 after the lerp; else raw values (ParamTabulatedProfile)

    Returns the tile-major (n_tiles, RB*K) map of sum over halos of
    curve(r) afac; untouched tiles and dead slots are zero. Kernel K10 for
    tensors on CUDA, the plain version for tensors on the CPU.
    """
    _check(tiling, csr, pack, PAINT_KEYS, "tile_paint")
    if pack["curves"].device.type == "cpu":
        return tile_paint_plain(tiling, csr, pack, float(ln_r0),
                                float(inv_dlnr), bool(log_curves))
    acc = torch.empty((tiling.n_tiles, tiling.P), dtype=pack["curves"].dtype,
                      device=pack["curves"].device)
    _launch("tile_paint", tiling, csr, pack, PAINT_KEYS, ln_r0, inv_dlnr,
            (int(bool(log_curves)),), acc)
    return acc


def tile_paint2(tiling, csr, pack, ln_r0, inv_dlnr, ln_r0_2, inv_dlnr_2,
                log_curves):
    """Paint every (tile, halo) pair's product of two curve lookups on the
    tile's slots: the halo sum of the anisotropic paint.

    tiling, csr : as :func:`tile_deposit`
    pack       : dict of per-halo tensors, ``PAINT2_KEYS``; the curves'
                 dtype (float32 or float64) is the paint's dtype
    ln_r0, inv_dlnr     : the first curve's grid (floats, used in that dtype)
    ln_r0_2, inv_dlnr_2 : the second curve's grid
    log_curves : both curves hold logs: the pair's value is exp(v1 + v2);
                 else both hold raw values and it is v1 v2

    Returns the tile-major (n_tiles, RB*K) map of sum over halos of
    afac v(r); untouched tiles and dead slots are zero. Kernel K12 for
    tensors on CUDA, the plain version for tensors on the CPU.
    """
    _check(tiling, csr, pack, PAINT2_KEYS, "tile_paint2")
    if pack["curves"].device.type == "cpu":
        return tile_paint2_plain(tiling, csr, pack, float(ln_r0),
                                 float(inv_dlnr), float(ln_r0_2),
                                 float(inv_dlnr_2), bool(log_curves))
    acc = torch.empty((tiling.n_tiles, tiling.P), dtype=pack["curves"].dtype,
                      device=pack["curves"].device)
    _launch("tile_paint2", tiling, csr, pack, PAINT_KEYS, ln_r0, inv_dlnr,
            (pack["curves2"].shape[1], float(ln_r0_2), float(inv_dlnr_2),
             int(bool(log_curves))), acc, (pack["curves2"].contiguous(),))
    return acc


def _launch(name, tiling, csr, pack, keys, ln_r0, inv_dlnr, extra, acc,
            more=()):
    """Launch ``bf_<name>`` (K4, K10 or K12) into ``acc``, every tile of
    which it writes (the untouched ones as zeros), with the tensors
    ``more`` after the pack's columns."""
    tiles, offsets, halos = csr
    dev = acc.device
    arr = tiling.device_arrays(dev)
    cols = [pack[k].contiguous() for k in keys]
    fn = getattr(_build.library(), "bf_{}_{}".format(
        name, "f32" if acc.dtype == torch.float32 else "f64"))
    with torch.cuda.device(dev):
        err = fn(tiling.nside, tiling.RB, tiling.K, tiling.n_tiles,
                 tiles.numel(),
                 _build.ptr(tiles), _build.ptr(offsets), _build.ptr(halos),
                 _build.ptr(arr["tile_i0"]), _build.ptr(arr["tile_s"]),
                 _build.ptr(arr["tile_S"]), _build.ptr(arr["center"]),
                 _build.ptr(arr["csc"]), *[_build.ptr(c) for c in cols],
                 *[_build.ptr(c) for c in more],
                 pack["curves"].shape[1], float(ln_r0), float(inv_dlnr),
                 *extra, _build.ptr(acc), _build.stream_of(acc))
    _build.check(err, name)
    _build.launches[name] += 1
