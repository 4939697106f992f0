"""Tiled phase B: the stencil regrid, its hot-tile test and its scatter
complement.

Almost every source pixel's displaced position stays within a couple of
pixels of itself, so its 4-neighbour bilinear share can be computed from
the target side: every target slot sums the weights of the displaced
sources in a small (ring, column) window around it. Sources that can move
further (hot tiles, found per call) and geometrically irregular regions
(``D_geom``: inner polar caps, sector-count transitions, dilated by one
tile) are excluded from the stencil and scattered by the complement, so
every (source, target) pair is handled exactly once.

Wrappers and plain versions (the wrapper runs its kernel for CUDA tensors
and the plain version for CPU tensors):

  hot_tiles / _plain             K5, entry stencil_hot: the per-tile test
                                 (reference HealpixRunner.py:1066-1069)
  stencil_regrid / _plain        K5, entry stencil: the stencil
                                 (reference tiles.py:1387-1619)
  stencil_weights_plain          K5's layout: the per-tile weight tables
                                 and their sum in the kernel's order
  stencil_geo / _plain           K6, entry stencil_geo: the once-per-NSIDE
                                 source list of D_geom (HealpixRunner.py:
                                 1102-1179) and the ring table
  stencil_rings_plain            K6's ring table (target and source form)
  source_angles_plain            a source's (theta, phi) from its pixel
                                 and the ring table, as the JAX list has
                                 them (_get_stencil_geo_ang)
  stencil_complement / _plain    K6, entry stencil_complement: the scatter
                                 of excluded sources into the flat map
                                 (HealpixRunner.py:1181-1303, with
                                 ``ops.regrid.displaced_weights``)

``stencil_tables`` puts ``ops.tiles.stencil_host_info``'s arrays on a
device, with the ring table the stencil kernel reads instead of evaluating
the ring functions. Offsets are (n_tiles, RB*K, 2) in the deposit dtype;
maps and the stencil's output are in the regrid dtype.
"""

import numpy as np
import torch

from . import _build
from . import healpix as hpx
from ..utils import trace
from .regrid import displaced_weights, ring_table_plain
from .tiles import _j0, valid_slot_counts

__all__ = ["stencil_tables", "ring_table", "hot_tiles", "hot_tiles_plain",
           "stencil_regrid", "stencil_regrid_plain", "stencil_weights_plain",
           "stencil_geo", "stencil_geo_plain", "stencil_rings_plain",
           "source_angles_plain", "stencil_complement",
           "stencil_complement_plain"]

# tiles / sources per step of the plain versions
_TILE_CHUNK = 1024
_SRC_CHUNK = 1 << 21


def ring_table(nside, device):
    """Per-ring data of the stencil's slab rows, rings 1 .. 4 nside - 1 at
    index i - 1, on ``device``, as :func:`_row_geometry` and
    :func:`stencil_regrid_plain` form them: ``theta`` and ``dphi`` =
    2 pi / nr (float64), ``nr`` and ``sh`` (shifted, int32), and
    ``colscale`` by regrid dtype: sin(theta) (1 below 1e-12) times dphi,
    both rounded to that dtype first."""
    r = torch.arange(1, 4 * nside, dtype=torch.int32, device=device)
    _, nr, _, sh = hpx.ring_info(nside, r, torch.float64)
    theta = hpx.ring_theta(nside, r, torch.float64)
    dphi = hpx.ring_dphi(nr)
    colscale = {}
    for dt in (torch.float32, torch.float64):
        sin_r = torch.sin(theta.to(dt))
        sin_safe = torch.where(sin_r > 1e-12, sin_r, torch.ones_like(sin_r))
        colscale[dt] = sin_safe * dphi.to(dt)
    return dict(theta=theta, dphi=dphi, nr=nr.to(torch.int32),
                sh=sh.to(torch.int32), colscale=colscale)


def stencil_tables(tiling, info, device):
    """``stencil_host_info``'s arrays on ``device``: the neighbour table
    ``nbr`` (n_tiles, 9) int32, per-tile thresholds ``th_theta`` /
    ``th_phi`` (float64), ``D_geom`` (bool), the geometric tiles
    ``g_tids`` (int32) and their valid-slot offsets ``g_off`` ((n_g +
    1,) int32) on the host and as ``g_off_dev`` on ``device``, plus W and
    Wc; and the NSIDE's :func:`ring_table` as ``ring``."""
    tb = tiling.tile_block
    g_tids = np.where(info["D_geom"])[0].astype(np.int32)
    counts = valid_slot_counts(tiling, g_tids)
    g_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return dict(
        nbr=trace.upload(info["nbr"].reshape(tiling.n_tiles, 9), device),
        th_theta=trace.upload(info["th_theta"][tb], device),
        th_phi=trace.upload(info["th_phi"][tb], device),
        D_geom=trace.upload(info["D_geom"], device),
        g_tids=trace.upload(g_tids, device), g_off=g_off,
        g_off_dev=trace.upload(g_off, device),
        W=int(info["W"]), Wc=int(info["Wc"]),
        ring=ring_table(tiling.nside, device))


def _suffix(*dts):
    return "_".join("f32" if d == torch.float32 else "f64" for d in dts)


def _check_tiled(tiling, x, trail, name):
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if tuple(x.shape) != (tiling.n_tiles, tiling.P) + trail:
        raise ValueError(f"{name}: need shape "
                         f"{(tiling.n_tiles, tiling.P) + trail}, not "
                         f"{tuple(x.shape)}")


# ---- hot-tile test (K5, stencil_hot) -------------------------------------
def hot_tiles_plain(acc, tables):
    """Plain version of :func:`hot_tiles`."""
    a = acc.abs()
    return ((a[:, :, 0].amax(dim=1).double() > tables["th_theta"])
            | (a[:, :, 1].amax(dim=1).double() > tables["th_phi"])
            | tables["D_geom"])


def hot_tiles(acc, tables):
    """Excluded source tiles (n_tiles,) bool: a tile whose largest
    |d theta| or |sin theta d phi| exceeds its block's threshold (compared
    in float64), or a tile of D_geom. ``acc`` is (n_tiles, RB*K, 2)."""
    if acc.dim() != 3 or acc.shape[2] != 2 \
            or acc.dtype not in (torch.float32, torch.float64):
        raise ValueError("hot_tiles: acc must be float (n_tiles, P, 2)")
    if acc.device.type == "cpu":
        return hot_tiles_plain(acc, tables)
    if acc.device.type != "cuda":
        raise ValueError(f"hot_tiles: unsupported device {acc.device}")
    acc = acc.contiguous()
    excl = torch.empty(acc.shape[0], dtype=torch.bool, device=acc.device)
    fn = getattr(_build.library(), "bf_stencil_hot_" + _suffix(acc.dtype))
    with torch.cuda.device(acc.device):
        err = fn(acc.shape[0], acc.shape[1], _build.ptr(acc),
                 _build.ptr(tables["th_theta"]), _build.ptr(tables["th_phi"]),
                 _build.ptr(tables["D_geom"]), _build.ptr(excl),
                 _build.stream_of(acc))
    _build.check(err, "stencil_hot")
    _build.count("stencil_hot")
    return excl


# ---- the stencil (K5, stencil) -------------------------------------------
def _row_geometry(tiling, i0, s, S, M, rdt):
    """Per-slab-row ring data of T tiles, rows i0 - M .. i0 + RB + M - 1
    (reference tiles.py:1409-1441): r_ok, theta (rdt), dphi and phi0
    (float64), and the centre / left segment lengths, each (T, R)."""
    N = tiling.nside
    r = i0[:, None] + torch.arange(-M, tiling.RB + M, dtype=torch.int32,
                                   device=i0.device)
    r_ok = (r >= 1) & (r <= 4 * N - 1)
    r_c = torch.clamp(r, 1, 4 * N - 1)
    _, nr, _, sh = hpx.ring_info(N, r_c, torch.float64)
    theta = hpx.ring_theta(N, r_c, torch.float64).to(rdt)
    sh_i = sh.to(torch.int32)
    S = S[:, None]
    s = s[:, None]
    sm = (s - 1) % S
    j0c = _j0(s, nr, sh_i, S)
    segC = _j0(s + 1, nr, sh_i, S) - j0c
    segL = (j0c - _j0(sm, nr, sh_i, S)) % nr
    dphi = hpx.ring_dphi(nr)
    phi0 = (j0c.double() + 0.5 * sh) * dphi
    return r_ok, theta, dphi, phi0, segC, segL


def _slabs(tiling, tables, po_tiled, orig_tiled, excl, t0, t1):
    """The slabs of tiles t0 .. t1 - 1 built by index arithmetic: the rows'
    theta (rdt), dphi and phi0 (float64), (T, R), and each cell's
    theta_src, c_src and value, (T, R, Q)."""
    RB, K, P = tiling.RB, tiling.K, tiling.P
    W, Wc = tables["W"], tables["Wc"]
    M = W
    rdt = orig_tiled.dtype
    dev = orig_tiled.device
    arr = tiling.device_arrays(dev)
    R, Q = RB + 2 * M, K + 2 * Wc
    po_flat = po_tiled.reshape(-1, 2)
    og_flat = orig_tiled.reshape(-1)
    rho = torch.arange(R, device=dev)
    db = (rho >= M).long() + (rho >= M + RB).long()                 # (R,)
    us = torch.where(rho < M, RB - M + rho,
                     torch.where(rho < M + RB, rho - M, rho - M - RB))
    jr = torch.arange(Q, device=dev) - Wc                           # (Q,)
    T = t1 - t0
    r_ok, theta_r, dphi_r, phi0_r, segC, segL = _row_geometry(
        tiling, arr["tile_i0"][t0:t1], arr["tile_s"][t0:t1],
        arr["tile_S"][t0:t1], M, rdt)
    # slab placement: left segment for q < Wc, then the centre's segC
    # slots, then the right segment
    segC3, segL3 = segC[:, :, None].long(), segL[:, :, None].long()
    left = (jr < 0).expand(T, R, Q)
    centre = ~left & (jr < segC3)
    v = torch.where(left, segL3 + jr,
                    torch.where(centre, jr.expand(T, R, Q), jr - segC3))
    col = torch.where(left, 0, torch.where(centre, 1, 2))
    okv = torch.where(left, v >= 0, v < K)
    nb = torch.gather(tables["nbr"][t0:t1].long(), 1,
                      (db[None, :, None] * 3 + col).reshape(T, -1)
                      ).reshape(T, R, Q)
    nbc = torch.clamp(nb, min=0)
    lin = (nbc * P + us[None, :, None] * K
           + torch.clamp(v, 0, K - 1))
    po = torch.where(okv[..., None], po_flat[lin],
                     torch.zeros((), dtype=po_flat.dtype, device=dev))
    og = og_flat[lin]
    ex = (nb < 0) | excl[nbc]
    og = torch.where(okv & ~ex & r_ok[:, :, None], og,
                     torch.zeros_like(og))

    sin_r = torch.sin(theta_r)
    sin_safe = torch.where(sin_r > 1e-12, sin_r, torch.ones_like(sin_r))
    col_scale = sin_safe * dphi_r.to(rdt)
    theta_src = theta_r[:, :, None] + po[..., 0].to(rdt)
    c_src = jr.to(rdt) + po[..., 1].to(rdt) / col_scale[:, :, None]
    return theta_r, dphi_r, phi0_r, theta_src, c_src, og


def _theta_steps(theta_r, M, RB):
    """Each target row's theta and its clamped steps to the rows above and
    below, (T, RB)."""
    th_t = theta_r[:, M:M + RB]
    dm = torch.clamp(th_t - theta_r[:, M - 1:M + RB - 1], min=1e-30)
    dp = torch.clamp(theta_r[:, M + 1:M + RB + 1] - th_t, min=1e-30)
    return th_t, dm, dp


def _wth(d, dm, dp):
    return torch.where(d <= 0, torch.clamp(1.0 + d / dm, min=0.0),
                       torch.clamp(1.0 - d / dp, min=0.0))


def stencil_regrid_plain(tiling, tables, po_tiled, orig_tiled, excl):
    """Plain version of :func:`stencil_regrid`, in tile chunks: the slab
    of every tile built by index arithmetic, then the 55-tap sweep."""
    RB, K, P = tiling.RB, tiling.K, tiling.P
    M, Wc = tables["W"], tables["Wc"]
    rdt = orig_tiled.dtype
    dev = orig_tiled.device
    vt = torch.arange(K, device=dev).to(rdt)
    out = torch.empty((tiling.n_tiles, P), dtype=rdt, device=dev)
    for t0 in range(0, tiling.n_tiles, _TILE_CHUNK):
        t1 = min(t0 + _TILE_CHUNK, tiling.n_tiles)
        theta_r, dphi_r, phi0_r, theta_src, c_src, og = _slabs(
            tiling, tables, po_tiled, orig_tiled, excl, t0, t1)
        th_t, dm, dp = _theta_steps(theta_r, M, RB)
        dphi_t = dphi_r[:, M:M + RB]
        phi0_t = phi0_r[:, M:M + RB]
        acc = torch.zeros((t1 - t0, RB, K), dtype=rdt, device=dev)
        for du in range(2 * M + 1):
            r0 = ((phi0_r[:, du:du + RB] - phi0_t) / dphi_t).to(rdt)
            rat = (dphi_r[:, du:du + RB] / dphi_t).to(rdt)
            for dv in range(2 * Wc + 1):
                ts = theta_src[:, du:du + RB, dv:dv + K]
                cs = c_src[:, du:du + RB, dv:dv + K]
                vs = og[:, du:du + RB, dv:dv + K]
                d = ts - th_t[:, :, None]
                wth = _wth(d, dm[:, :, None], dp[:, :, None])
                x = r0[:, :, None] + cs * rat[:, :, None] - vt
                wph = torch.clamp(1.0 - torch.abs(x), min=0.0)
                acc = acc + wth * wph * vs
        out[t0:t1] = acc.reshape(t1 - t0, P)
    return out


def stencil_weights_plain(tiling, tables, po_tiled, orig_tiled, excl):
    """Plain version of K5's layout: each tile's weight tables and their
    sum in the kernel's order. Returns (out, weights): ``out`` as
    :func:`stencil_regrid`; ``weights`` of the tiles, by target row u and
    tap row du: ``r0`` and ``rat`` (n_tiles, RB, 2W+1), ``wth`` and ``y``
    = r0 + c_src rat where wth is not 0, else 0 (n_tiles, RB, 2W+1, K +
    2Wc) in the regrid dtype, and
    ``live`` (n_tiles, RB, 2W+1), the tap rows with a nonzero wth (the
    kernel skips those of the others that the range of their theta
    offsets rules out). Each slot then sums, tap rows outer and
    columns inner, (wth wph) v with x = y - vt and wph = max(0, 1 - |x|):
    bitwise :func:`stencil_regrid_plain` for finite inputs."""
    RB, K, P = tiling.RB, tiling.K, tiling.P
    M, Wc = tables["W"], tables["Wc"]
    D = 2 * M + 1
    rdt = orig_tiled.dtype
    dev = orig_tiled.device
    vt = torch.arange(K, device=dev).to(rdt)
    out = torch.empty((tiling.n_tiles, P), dtype=rdt, device=dev)
    parts = []
    for t0 in range(0, tiling.n_tiles, _TILE_CHUNK):
        t1 = min(t0 + _TILE_CHUNK, tiling.n_tiles)
        theta_r, dphi_r, phi0_r, theta_src, c_src, og = _slabs(
            tiling, tables, po_tiled, orig_tiled, excl, t0, t1)
        th_t, dm, dp = _theta_steps(theta_r, M, RB)
        dphi_t = dphi_r[:, M:M + RB]
        phi0_t = phi0_r[:, M:M + RB]
        rows = torch.arange(RB, device=dev)[:, None] \
            + torch.arange(D, device=dev)[None, :]                  # (RB, D)
        r0 = ((phi0_r[:, rows] - phi0_t[:, :, None])
              / dphi_t[:, :, None]).to(rdt)
        rat = (dphi_r[:, rows] / dphi_t[:, :, None]).to(rdt)
        d = theta_src[:, rows] - th_t[:, :, None, None]     # (T, RB, D, Q)
        wth = _wth(d, dm[:, :, None, None], dp[:, :, None, None])
        # y only where wth is not 0, as the kernel forms it (a tap of wth 0
        # adds 0 whatever its y)
        y = torch.where(wth != 0,
                        r0[..., None] + c_src[:, rows] * rat[..., None],
                        torch.zeros((), dtype=rdt, device=dev))
        live = (wth != 0).any(dim=3)
        v = og[:, rows]
        acc = torch.zeros((t1 - t0, RB, K), dtype=rdt, device=dev)
        for du in range(D):
            on = live[:, :, du, None]
            for dv in range(2 * Wc + 1):
                x = y[:, :, du, dv:dv + K] - vt
                wph = torch.clamp(1.0 - torch.abs(x), min=0.0)
                term = wth[:, :, du, dv:dv + K] * wph * v[:, :, du, dv:dv + K]
                acc = torch.where(on, acc + term, acc)
        out[t0:t1] = acc.reshape(t1 - t0, P)
        parts.append((r0, rat, wth, y, live))
    weights = {k: torch.cat([p[i] for p in parts])
               for i, k in enumerate(("r0", "rat", "wth", "y", "live"))}
    return out, weights


def stencil_regrid(tiling, tables, po_tiled, orig_tiled, excl):
    """The stencil part of the regrid, (n_tiles, RB*K) in the map's dtype:
    every target slot's sum over its (2W+1) x (2Wc+1) window of the sources
    of tiles not in ``excl``.

    po_tiled   : (n_tiles, RB*K, 2) offsets, float32 or float64
    orig_tiled : (n_tiles, RB*K) map (``SkyTiling.tile_view``), in the
                 regrid dtype
    excl       : (n_tiles,) bool, from :func:`hot_tiles`

    The kernel takes 1 <= W <= 127, Wc >= 2 and RB * ceil(K / 4) <= 256
    (the runners' 16 x 32 tiles, W 2, Wc 5), else it raises.
    """
    _check_tiled(tiling, po_tiled, (2,), "stencil_regrid")
    _check_tiled(tiling, orig_tiled, (), "stencil_regrid")
    dev = orig_tiled.device
    if po_tiled.device != dev or excl.device != dev:
        raise ValueError("stencil_regrid: inputs on different devices")
    if dev.type == "cpu":
        return stencil_regrid_plain(tiling, tables, po_tiled, orig_tiled,
                                    excl)
    if dev.type != "cuda":
        raise ValueError(f"stencil_regrid: unsupported device {dev}")
    arr = tiling.device_arrays(dev)
    ring = tables["ring"]
    po = po_tiled.contiguous()
    og = orig_tiled.contiguous()
    out = torch.empty_like(og)
    fn = getattr(_build.library(),
                 "bf_stencil_" + _suffix(po.dtype, og.dtype))
    with torch.cuda.device(dev):
        err = fn(tiling.nside, tiling.RB, tiling.K, tiling.n_tiles,
                 tables["W"], tables["Wc"], _build.ptr(arr["tile_i0"]),
                 _build.ptr(arr["tile_s"]), _build.ptr(arr["tile_S"]),
                 _build.ptr(tables["nbr"]), _build.ptr(ring["theta"]),
                 _build.ptr(ring["dphi"]), _build.ptr(ring["nr"]),
                 _build.ptr(ring["sh"]),
                 _build.ptr(ring["colscale"][og.dtype]), _build.ptr(po),
                 _build.ptr(og),
                 _build.ptr(excl.contiguous()), _build.ptr(out),
                 _build.stream_of(out))
    _build.check(err, "stencil")
    _build.count("stencil")
    return out


# ---- the complement's source list (K6, stencil_geo) ------------------------
def stencil_rings_plain(nside, dtype, device="cpu"):
    """Plain version of K6's ring table: (8 nside, 4) in ``dtype``. Row i
    (ring i, 1 .. 4 nside - 1) is the target form, as interp_weights takes
    a ring: theta, the phi step 2 pi / nr and the clamped sin, K3's
    (:func:`ops.regrid.ring_table_plain`); row 4 nside + i the source form,
    as the JAX list takes a source's ring: the float64 ring_theta rounded
    to ``dtype``, the same phi step, and the sin of that theta (1 where it
    is not above 1e-12). The fourth column and rows 0 and 4 nside are 0.
    In float64 the two forms are the same."""
    theta, dphi, sin_safe = ring_table_plain(nside, dtype, device)
    r = torch.arange(1, 4 * nside, dtype=torch.int32, device=device)
    th_s = hpx.ring_theta(nside, r, torch.float64).to(dtype)
    s = torch.sin(th_s)
    rows = torch.zeros((2, 4 * nside, 4), dtype=dtype, device=device)
    rows[0, 1:, :3] = torch.stack([theta, dphi, sin_safe], 1)
    rows[1, 1:, :3] = torch.stack(
        [th_s, dphi, torch.where(s > 1e-12, s, torch.ones_like(s))], 1)
    return rows.reshape(8 * nside, 4)


def source_angles_plain(nside, pix, rows):
    """The (theta, phi) of sources at int32 pixels ``pix`` in the table's
    dtype, as K6 forms them: theta the source form of the pixel's ring in
    ``rows`` (:func:`stencil_rings_plain`), phi (jw + shifted / 2) 2 pi /
    nr in float64 (a true division) rounded once: the JAX list's
    (``_get_stencil_geo_ang``) formulas."""
    ring = hpx.pixel_ring(nside, pix)
    sp, nr, _, sh = hpx.ring_info(nside, ring)
    step = hpx.ring_dphi(nr)
    phi = ((pix - sp).double() + 0.5 * sh) * step
    return rows[4 * nside + ring.long(), 0], phi.to(rows.dtype)


def stencil_geo_plain(tiling, tables, rdt):
    """Plain version of :func:`stencil_geo`."""
    g = tables["g_tids"]
    dev = g.device
    arr = tiling.device_arrays(dev)
    P = tiling.P
    parts = []
    for t0 in range(0, g.numel(), _TILE_CHUNK):
        gt = g[t0:t0 + _TILE_CHUNK].long()
        pix, valid = tiling.slot_pix(arr["tile_i0"][gt], arr["tile_s"][gt],
                                     arr["tile_S"][gt])
        sel = valid.reshape(-1)
        sf = (gt[:, None] * P + torch.arange(P, device=dev)).reshape(-1)
        parts.append((sf[sel].to(torch.int32),
                      pix.reshape(-1)[sel].to(torch.int32)))
    rows = stencil_rings_plain(tiling.nside, rdt, dev)
    if not parts:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return empty, empty.clone(), rows
    return tuple(torch.cat(c) for c in zip(*parts)) + (rows,)


def stencil_geo(tiling, tables, rdt):
    """The compact list of the valid slots of the D_geom tiles, tiles
    ascending and slots in order, and the ring table: (slot ids int32 as
    tile * RB*K + slot, pixels int32, the table (8 nside, 4) in ``rdt``,
    as :func:`stencil_rings_plain`). A pure function of the tiling, built
    once per NSIDE and regrid dtype."""
    g = tables["g_tids"]
    dev = g.device
    if dev.type == "cpu":
        return stencil_geo_plain(tiling, tables, rdt)
    if dev.type != "cuda":
        raise ValueError(f"stencil_geo: unsupported device {dev}")
    n = int(tables["g_off"][-1])
    arr = tiling.device_arrays(dev)
    sf = torch.empty(n, dtype=torch.int32, device=dev)
    pix = torch.empty(n, dtype=torch.int32, device=dev)
    rows = torch.empty((8 * tiling.nside, 4), dtype=rdt, device=dev)
    fn = getattr(_build.library(), "bf_stencil_geo_" + _suffix(rdt))
    with torch.cuda.device(dev):
        err = fn(tiling.nside, tiling.RB, tiling.K, g.numel(),
                 _build.ptr(g), _build.ptr(tables["g_off_dev"]),
                 _build.ptr(arr["tile_i0"]), _build.ptr(arr["tile_s"]),
                 _build.ptr(arr["tile_S"]), _build.ptr(sf), _build.ptr(pix),
                 _build.ptr(rows), _build.stream_of(sf))
    _build.check(err, "stencil_geo")
    _build.count("stencil_geo")
    return sf, pix, rows


# ---- the complement (K6, stencil_complement) -------------------------------
def _scatter(nside, out, po, og, self_pix, rows):
    theta_p, phi_p = source_angles_plain(nside, self_pix, rows)
    cpix, cw = displaced_weights(nside, out.dtype, self_pix, po, theta_p,
                                 phi_p)
    out.index_add_(0, cpix.reshape(-1).long(),
                   (cw * og[:, None]).reshape(-1))


def stencil_complement_plain(tiling, out, acc, orig_tiled, geo, hot_ids):
    """Plain version of :func:`stencil_complement`."""
    dev = out.device
    N, P = tiling.nside, tiling.P
    sf, gpix, rows = geo
    po_flat = acc.reshape(-1, 2)
    og_flat = orig_tiled.reshape(-1)
    for start in range(0, sf.numel(), _SRC_CHUNK):
        idx = sf[start:start + _SRC_CHUNK].long()
        _scatter(N, out, po_flat[idx], og_flat[idx],
                 gpix[start:start + _SRC_CHUNK], rows)
    if hot_ids.numel():
        arr = tiling.device_arrays(dev)
        for t0 in range(0, hot_ids.numel(), _TILE_CHUNK):
            ht = hot_ids[t0:t0 + _TILE_CHUNK].long()
            pix, valid = tiling.slot_pix(
                arr["tile_i0"][ht], arr["tile_s"][ht], arr["tile_S"][ht])
            sel = valid.reshape(-1)
            idx = (ht[:, None] * P
                   + torch.arange(P, device=dev)).reshape(-1)[sel]
            _scatter(N, out, po_flat[idx], og_flat[idx],
                     pix.reshape(-1)[sel].to(torch.int32), rows)
    return out


def stencil_complement(tiling, out, acc, orig_tiled, geo, hot_ids):
    """Add the scatter complement of the stencil into the flat map ``out``
    (npix,) in place and return it: every valid slot of the geometric list
    ``geo`` (:func:`stencil_geo`, whose ring table is in the map's dtype)
    and of the hot tiles ``hot_ids`` (int32, on the same device) moves by
    its offset in ``acc`` (n_tiles, RB*K, 2) and shares its
    ``orig_tiled`` value among the 4 interpolation neighbours of its new
    position; an unmoved source adds its value to its own pixel."""
    _check_tiled(tiling, acc, (2,), "stencil_complement")
    _check_tiled(tiling, orig_tiled, (), "stencil_complement")
    sf, gpix, rows = geo
    if out.shape != (tiling.npix,) or out.dtype != orig_tiled.dtype \
            or rows.dtype != out.dtype \
            or rows.shape != (8 * tiling.nside, 4):
        raise ValueError("stencil_complement: out must be (npix,) in the "
                         "map's dtype, and geo's ring table in it too")
    dev = out.device
    if dev.type == "cpu":
        return stencil_complement_plain(tiling, out, acc, orig_tiled, geo,
                                        hot_ids)
    if dev.type != "cuda":
        raise ValueError(f"stencil_complement: unsupported device {dev}")
    arr = tiling.device_arrays(dev)
    acc = acc.contiguous()
    og = orig_tiled.contiguous()
    hot = (hot_ids if hot_ids.dtype == torch.int32
           else hot_ids.to(torch.int32)).contiguous()
    fn = getattr(_build.library(),
                 "bf_stencil_complement_" + _suffix(acc.dtype, out.dtype))
    with torch.cuda.device(dev):
        err = fn(tiling.nside, tiling.RB, tiling.K, sf.numel(),
                 _build.ptr(sf), _build.ptr(gpix), _build.ptr(rows),
                 hot.numel(), _build.ptr(hot), _build.ptr(arr["tile_i0"]),
                 _build.ptr(arr["tile_s"]), _build.ptr(arr["tile_S"]),
                 _build.ptr(acc), _build.ptr(og), _build.ptr(out),
                 _build.stream_of(out))
    _build.check(err, "stencil_complement")
    _build.count("stencil_complement")
    return out
