"""Tiled phase A: the per-tile (slot, halo) pair deposit of tangent-angle
offsets.

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
"""

import torch

from . import _build

__all__ = ["tile_deposit", "tile_deposit_plain", "PACK_KEYS"]

# per-halo columns: vh (n, 3) float64 unit vectors; the rest in the
# deposit dtype: crit2 = (2 sin(min(radius, pi)/2))^2, lnDa = ln(D/a) +
# ln(rscale), invD = 1/D, afac = a, curves (n, n_r)
PACK_KEYS = ("vh", "crit2", "lnDa", "invD", "afac", "curves")

# tiles and pairs per step of the plain version
_TILE_CHUNK = 1024
_PAIR_CHUNK = 2048


def _check(tiling, csr, pack):
    curves = pack["curves"]
    dt, dev = curves.dtype, curves.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"tile_deposit: unsupported dtype {dt}")
    if curves.dim() != 2 or curves.shape[1] < 2:
        raise ValueError("tile_deposit: curves must be (n_halos, n_r >= 2)")
    n = curves.shape[0]
    for k in PACK_KEYS:
        x = pack[k]
        want = ((n, 3), torch.float64) if k == "vh" else (
            (n,) if k != "curves" else (n, curves.shape[1]), dt)
        if tuple(x.shape) != want[0] or x.dtype != want[1] \
                or x.device != dev:
            raise ValueError(f"tile_deposit: pack[{k!r}] must be a "
                             f"{want[1]} {want[0]} tensor on {dev}")
    tiles, offsets, halos = csr
    for name, x in (("tiles", tiles), ("offsets", offsets),
                    ("halos", halos)):
        if x.dtype != torch.int32 or x.dim() != 1 or x.device != dev:
            raise ValueError(f"tile_deposit: {name} must be a 1-D int32 "
                             f"tensor on {dev}")
    if offsets.numel() != tiles.numel() + 1:
        raise ValueError("tile_deposit: need len(offsets) == len(tiles) + 1")


def tile_deposit_plain(tiling, csr, pack, ln_r0, inv_dlnr):
    """Plain version of K4, in tile and pair chunks. Arguments as
    :func:`tile_deposit`."""
    curves = pack["curves"]
    dt, dev = curves.dtype, curves.device
    n_r = curves.shape[1]
    P = tiling.P
    acc = torch.zeros((tiling.n_tiles, P, 2), dtype=dt, device=dev)
    tiles, offsets, halos = csr
    T = tiles.numel()
    if T == 0:
        return acc
    arr = tiling.device_arrays(dev)
    offs = offsets.cpu().tolist()
    pair_tile = torch.repeat_interleave(
        torch.arange(T, device=dev), (offsets[1:] - offsets[:-1]).long())
    for t0 in range(0, T, _TILE_CHUNK):
        t1 = min(t0 + _TILE_CHUNK, T)
        tid = tiles[t0:t1].long()
        dp, valid, e_th, e_ph, a_th, a_ph = tiling.slot_local(
            arr["tile_i0"][tid], arr["tile_s"][tid], arr["tile_S"][tid],
            arr["csc"][tid], dt, tangent=True)
        c32 = arr["center"][tid].to(dt)
        s0 = torch.zeros((t1 - t0, P), dtype=dt, device=dev)
        sth = torch.zeros_like(s0)
        sph = torch.zeros_like(s0)
        for q0 in range(offs[t0], offs[t1], _PAIR_CHUNK):
            q1 = min(q0 + _PAIR_CHUNK, offs[t1])
            lt = pair_tile[q0:q1] - t0
            h = halos[q0:q1].long()
            dh = pack["vh"][h].to(dt) - c32[lt]                  # (n, 3)
            dpp = dp[lt]
            d0 = dh[:, 0:1] - dpp[:, 0]
            d1 = dh[:, 1:2] - dpp[:, 1]
            d2 = dh[:, 2:3] - dpp[:, 2]
            chord2 = d0 * d0 + d1 * d1 + d2 * d2
            chord2 = torch.clamp(chord2, min=1e-30)
            lnr = 0.5 * torch.log(chord2) + pack["lnDa"][h][:, None]
            x = (lnr - ln_r0) * inv_dlnr
            i = torch.clamp(x.to(torch.int32), 0, n_r - 2)
            t = x - i.to(dt)
            cv = curves[h]
            il = i.long()
            val = (torch.gather(cv, 1, il) * (1.0 - t)
                   + torch.gather(cv, 1, il + 1) * t)
            use = ((x >= 0) & (x <= n_r - 1)
                   & (chord2 <= pack["crit2"][h][:, None]))
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
        out = torch.where(valid.reshape(t1 - t0, P, 1), out,
                          torch.zeros_like(out))
        acc[tid] = torch.where(torch.isfinite(out), out,
                               torch.zeros_like(out))
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
    dev = pack["curves"].device
    if dev.type == "cpu":
        return tile_deposit_plain(tiling, csr, pack, float(ln_r0),
                                  float(inv_dlnr))
    if dev.type != "cuda":
        raise ValueError(f"tile_deposit: unsupported device {dev}")
    if tiling.P > 1024:
        raise ValueError("tile_deposit: K4 runs one thread per slot and "
                         f"takes tiles of at most 1024 slots, not {tiling.P}")
    dt = pack["curves"].dtype
    n_r = pack["curves"].shape[1]
    if (7 + n_r) * pack["curves"].element_size() > 48 * 1024:
        raise ValueError(f"tile_deposit: curves of {n_r} points do not fit "
                         "K4's 48 KB of shared memory for one halo")
    acc = torch.zeros((tiling.n_tiles, tiling.P, 2), dtype=dt, device=dev)
    tiles, offsets, halos = csr
    if tiles.numel() == 0:
        return acc
    arr = tiling.device_arrays(dev)
    cols = [pack[k].contiguous() for k in PACK_KEYS]
    fn = getattr(_build.library(), "bf_tile_deposit_{}".format(
        "f32" if dt == torch.float32 else "f64"))
    with torch.cuda.device(dev):
        err = fn(tiling.nside, tiling.RB, tiling.K, tiles.numel(),
                 _build.ptr(tiles), _build.ptr(offsets), _build.ptr(halos),
                 _build.ptr(arr["tile_i0"]), _build.ptr(arr["tile_s"]),
                 _build.ptr(arr["tile_S"]), _build.ptr(arr["center"]),
                 _build.ptr(arr["csc"]), *[_build.ptr(c) for c in cols],
                 n_r, float(ln_r0), float(inv_dlnr), _build.ptr(acc),
                 _build.stream_of(acc))
    _build.check(err, "tile_deposit")
    _build.launches["tile_deposit"] += 1
    return acc
