"""Disjoint sky tiling of a RING-ordered HEALPix sphere, for the tiled
engine of ``BaryonifyShell`` (tile deposit, stencil regrid).

Port of ``baryonforge_tpu.ops.tiles``. The sphere is cut into static
rectangular tiles (ring blocks x phi sectors): tile (b, s) covers rings
[1 + b*RB, 1 + (b+1)*RB) and, on each ring, the pixels of phi sector s of
S_b. Slot (u, v) of a tile is ring i = i0 + u, in-ring index j0(s) + v;
a tile has RB*K slots, and cap segments shorter than K leave dead slots.

Host half (numpy, copied from the JAX package so that its arrays are
equal): ``SkyTiling``'s per-tile arrays, ``bin_halos_to_tiles``,
``refine_pairs`` (its pruned "near" pairs; the port runs no far/near curve
windowing), ``count_valid_slots`` and ``stencil_host_info``, plus
``pairs_csr``, which groups the pairs per tile.

Device half (torch, batched over tiles instead of vmapped): the slot
geometry ``slot_local``, ``slot_pixels``, ``slot_pix``, ``slot_index``,
and the slot <-> RING re-layout ``tile_view`` / ``flat_view``, which are
the wrappers of kernel K7 (``csrc/tile_layout.cu``); ``tile_view_plain``
and ``flat_view_plain`` are its plain versions.

Precision follows the JAX package under x64: ring data, ``2 pi / nr``,
the azimuth offset of a slot from its tile centre and its wrap are
float64; only the small local quantities are in the working dtype.
"""

import math

import numpy as np
import torch

from . import _build
from . import healpix as hpx
from ..utils import trace

__all__ = ["DEFAULT_SHAPE", "SkyTiling", "bin_halos_to_tiles",
           "refine_pairs", "pairs_csr", "count_valid_slots",
           "valid_slot_counts", "stencil_host_info"]

_TWO_PI = 2.0 * math.pi

# SkyTiling's (ring_block, seg_slots) unless told otherwise
DEFAULT_SHAPE = (16, 32)

# pixels / tiles per step of the plain re-layouts
_PIX_CHUNK = 1 << 22
_TILE_CHUNK = 4096


def _j0(s, nr, sh, S):
    """First in-ring index of sector ``s`` (integer math, floor division)."""
    return (2 * s * nr - sh * S + 2 * S - 1) // (2 * S)


class SkyTiling:
    """Static tiling of a RING-ordered HEALPix sphere (reference
    baryonforge_tpu/ops/tiles.py:76-196).

    Parameters
    ----------
    nside : int
    ring_block : rings per block (RB)
    seg_slots : slots per ring segment (K); the sector count is sized for
        the equatorial rings, S = ceil(4 nside / (K - 2)), in every block
        (so blocks above and below a tile share its sectors, which the
        stencil regrid needs), with belt blocks tightened to 4 nside / K
        when that divides exactly.
    """

    def __init__(self, nside, ring_block=DEFAULT_SHAPE[0],
                 seg_slots=DEFAULT_SHAPE[1]):
        self.nside = int(nside)
        self.RB = int(ring_block)
        self.K = int(seg_slots)
        N = self.nside
        if not 1 <= N <= hpx.MAX_NSIDE:
            raise ValueError(f"SkyTiling: NSIDE {N} outside "
                             f"[1, {hpx.MAX_NSIDE}] (int32 slot math)")
        n_rings = 4 * N - 1
        self.n_blocks = -(-n_rings // self.RB)

        i0 = 1 + self.RB * np.arange(self.n_blocks)
        i_hi = np.minimum(i0 + self.RB - 1, n_rings)
        nr_max = np.full(self.n_blocks, 4 * N)
        self.S = np.maximum(1, -(-nr_max // (self.K - 2))).astype(np.int64)
        belt = (i0 >= N) & (i_hi <= 3 * N)
        if 4 * N % self.K == 0:
            self.S = np.where(belt, 4 * N // self.K, self.S)
        self._belt_exact = belt & (self.S * self.K == 4 * N)
        self.i0 = i0.astype(np.int64)
        self.tile_off = np.concatenate([[0], np.cumsum(self.S)])
        self.n_tiles = int(self.tile_off[-1])

        self.tile_block = np.repeat(np.arange(self.n_blocks), self.S)
        self.tile_s = (np.arange(self.n_tiles)
                       - self.tile_off[self.tile_block])
        self.tile_i0 = self.i0[self.tile_block]
        self.tile_S = self.S[self.tile_block]

        th_lo = _ring_theta_np(N, np.maximum(self.i0 - 0.5, 0.5))
        th_hi = _ring_theta_np(
            N, np.minimum(self.i0 + self.RB - 0.5, n_rings + 0.5))
        self.block_th_lo = th_lo
        self.block_th_hi = th_hi
        th_c = 0.5 * (th_lo + th_hi)[self.tile_block]
        ph_c = 2.0 * np.pi * (self.tile_s + 0.5) / self.tile_S
        st, ct = np.sin(th_c), np.cos(th_c)
        self.tile_center = np.stack(
            [st * np.cos(ph_c), st * np.sin(ph_c), ct], axis=1)
        self._memo = {}
        self._csc = None
        self._dev = {}
        # fills the memos (circumradii, device arrays): a tiling shared
        # across threads (ops.geometry) is given one that locks
        self._fill = trace.cached

    @property
    def P(self):
        """Slots per tile, RB * K."""
        return self.RB * self.K

    @property
    def npix(self):
        return hpx.npix(self.nside)

    @property
    def tile_crad(self):
        """Per-tile circumradius in chord units: an upper bound (float64
        exact + 1e-5 margin) on |v_pixel - tile_center| over the tile's
        valid slot pixel centres (the pair pruning's bound); made at first
        use (``cache.crad``)."""
        return self._fill(self._memo, "crad", "crad", self._circumradii)

    def _circumradii(self):
        N, RB, K = self.nside, self.RB, self.K
        i = (self.tile_i0[:, None].astype(np.int64)
             + np.arange(RB, dtype=np.int64)[None, :])
        ok = (i >= 1) & (i <= 4 * N - 1)
        i_c = np.clip(i, 1, 4 * N - 1)
        north = i_c < N
        south = i_c > 3 * N
        nr = np.where(north, 4 * i_c,
                      np.where(south, 4 * (4 * N - i_c), 4 * N))
        sh = np.where(north | south, 1,
                      np.where((i_c - N) % 2 == 0, 1, 0))
        s = self.tile_s[:, None].astype(np.int64)
        S = self.tile_S[:, None].astype(np.int64)
        j0 = (2 * s * nr - sh * S + 2 * S - 1) // (2 * S)
        j1 = (2 * (s + 1) * nr - sh * S + 2 * S - 1) // (2 * S)
        seg = np.minimum(j1 - j0, K)
        ok &= seg > 0
        th_r = _ring_theta_np(N, i_c.astype(np.float64))
        dphi = 2.0 * np.pi / nr
        ph_c = 2.0 * np.pi * (self.tile_s + 0.5) / self.tile_S
        phf = (j0 + 0.5 * sh) * dphi - ph_c[:, None]
        phl = (j0 + seg - 1 + 0.5 * sh) * dphi - ph_c[:, None]

        def wrap(a):
            return np.abs(np.mod(a + np.pi, 2 * np.pi) - np.pi)

        dph = np.maximum(wrap(phf), wrap(phl))
        th_c = np.arccos(np.clip(self.tile_center[:, 2], -1, 1))
        cosd = (np.sin(th_r) * np.sin(th_c)[:, None] * np.cos(dph)
                + np.cos(th_r) * np.cos(th_c)[:, None])
        chord2 = np.where(ok, 2.0 - 2.0 * cosd, 0.0)
        return (np.sqrt(chord2.max(axis=1)) + 1e-5).astype(np.float64)

    @property
    def center_sincos(self):
        """(n_tiles, 5) float64 [sin th_c, cos th_c, sin ph_c, cos ph_c,
        ph_c] of the tile centres (consistent with ``tile_center``)."""
        if self._csc is None:
            th_c = np.arccos(np.clip(self.tile_center[:, 2], -1, 1))
            ph_c = 2.0 * np.pi * (self.tile_s + 0.5) / self.tile_S
            self._csc = np.stack([np.sin(th_c), np.cos(th_c),
                                  np.sin(ph_c), np.cos(ph_c), ph_c],
                                 axis=1)
        return self._csc

    def device_arrays(self, device):
        """The per-tile and per-block arrays as tensors on ``device``
        (int32 ids, float64 centres), built once per device:
        ``tile_i0``, ``tile_s``, ``tile_S``, ``S`` (per block),
        ``tile_off`` (n_blocks + 1), ``center`` (n_tiles, 3) and ``csc``
        (n_tiles, 5) (``cache.tiling_device``)."""
        def build():
            def i32(x):
                return trace.upload(np.asarray(x, np.int32), device)

            return dict(
                tile_i0=i32(self.tile_i0), tile_s=i32(self.tile_s),
                tile_S=i32(self.tile_S), S=i32(self.S),
                tile_off=i32(self.tile_off),
                center=trace.upload(self.tile_center, device),
                csc=trace.upload(self.center_sincos, device))
        return self._fill(self._dev, str(torch.device(device)),
                          "tiling_device", build)

    # -- device-side closed-form geometry, batched over tiles ------------
    def _segments(self, i0_t, s_t, S_t):
        """Per (tile, ring-row) integer ring data for int32 tile columns
        (T,): ring_ok, i_c, sp, nr, sh (int), j0, j1, each (T, RB)."""
        N, RB = self.nside, self.RB
        u = torch.arange(RB, dtype=torch.int32, device=i0_t.device)
        i = i0_t.to(torch.int32)[:, None] + u[None, :]
        ring_ok = (i >= 1) & (i <= 4 * N - 1)
        i_c = torch.clamp(i, 1, 4 * N - 1)
        sp, nr, _, sh = hpx.ring_info(N, i_c, torch.float64)
        sh_i = sh.to(torch.int32)
        S = S_t.to(torch.int32)[:, None]
        s = s_t.to(torch.int32)[:, None]
        j0 = _j0(s, nr, sh_i, S)
        j1 = _j0(s + 1, nr, sh_i, S)
        return ring_ok, i_c, sp, nr, sh, j0, j1

    def _slots(self, i0_t, s_t, S_t):
        ring_ok, i_c, sp, nr, sh, j0, j1 = self._segments(i0_t, s_t, S_t)
        v = torch.arange(self.K, dtype=torch.int32, device=i0_t.device)
        j = j0[:, :, None] + v
        valid = (v < (j1 - j0)[:, :, None]) & ring_ok[:, :, None]
        return valid, j, i_c, sp, nr, sh

    def slot_local(self, i0_t, s_t, S_t, csc_t, dtype=torch.float32,
                   tangent=False):
        """Tile-local slot geometry in ``dtype`` (reference tiles.py:198-282)
        for T tiles: with per-tile float64 sin/cos of the centre and
        per-ring float64 differences, the local offset dp = v_pix - c comes
        out with absolute error ~eps * |dp|.

          A  = (sin th_r - sin th_c) - sin th_r * 2 sin^2(d/2)
          B  = sin th_r * sin d
          dp = (cph_c*A - sph_c*B,  sph_c*A + cph_c*B, cos th_r - cos th_c)

        Returns dp (T, 3, P) and valid (T, RB, K); with ``tangent`` also the
        slot tangent basis e_th, e_ph (T, 3, P) and the projections
        a_th = dp.e_th, a_ph = dp.e_ph (T, P)."""
        N = self.nside
        T, P = i0_t.shape[0], self.P
        valid, j, i_c, _, nr, sh = self._slots(i0_t, s_t, S_t)
        csc_t = csc_t.to(torch.float64)
        sthc, cthc, sphc, cphc, ph_c64 = (csc_t[:, k, None]
                                          for k in range(5))
        theta_r = hpx.ring_theta(N, i_c, torch.float64)        # (T, RB)
        sth_r = torch.sin(theta_r)
        cth_r = torch.cos(theta_r)
        dsin = (sth_r - sthc).to(dtype)[:, :, None]
        dcos = (cth_r - cthc).to(dtype)[:, :, None]
        sth32 = sth_r.to(dtype)[:, :, None]
        cth32 = cth_r.to(dtype)[:, :, None]

        dphi = hpx.ring_dphi(nr)
        d = ((j.double() + 0.5 * sh[:, :, None]) * dphi[:, :, None]
             - ph_c64[:, :, None])
        d = torch.remainder(d + math.pi, _TWO_PI) - math.pi
        d32 = d.to(dtype)                                      # (T, RB, K)

        s2 = torch.sin(0.5 * d32)
        c2 = torch.cos(0.5 * d32)
        sind = 2.0 * s2 * c2
        cosm1 = -2.0 * s2 * s2
        A = dsin + sth32 * cosm1
        B = sth32 * sind
        sphc32 = sphc.to(dtype)[:, :, None]
        cphc32 = cphc.to(dtype)[:, :, None]
        dp = torch.stack([cphc32 * A - sphc32 * B,
                          sphc32 * A + cphc32 * B,
                          dcos.expand(A.shape)], dim=1).reshape(T, 3, P)
        if not tangent:
            return dp, valid
        cosd = 1.0 + cosm1
        sinp = sphc32 * cosd + cphc32 * sind
        cosp = cphc32 * cosd - sphc32 * sind
        e_th = torch.stack([cth32 * cosp, cth32 * sinp,
                            (-sth32).expand(A.shape)],
                           dim=1).reshape(T, 3, P)
        e_ph = torch.stack([-sinp, cosp, torch.zeros_like(sinp)],
                           dim=1).reshape(T, 3, P)
        a_th = dp[:, 0] * e_th[:, 0] + dp[:, 1] * e_th[:, 1] \
            + dp[:, 2] * e_th[:, 2]
        a_ph = dp[:, 0] * e_ph[:, 0] + dp[:, 1] * e_ph[:, 1] \
            + dp[:, 2] * e_ph[:, 2]
        return dp, valid, e_th, e_ph, a_th, a_ph

    def slot_pixels(self, i0_t, s_t, S_t):
        """Per-slot (pix int32, phi float64, valid) (T, RB, K) and per-ring
        theta_r float64 (T, RB) of T tiles (reference tiles.py:285-308)."""
        valid, j, i_c, sp, nr, sh = self._slots(i0_t, s_t, S_t)
        nr3 = nr[:, :, None]
        jw = torch.where(j < nr3, j, j - nr3)
        pix = sp[:, :, None] + jw
        theta_r = hpx.ring_theta(self.nside, i_c, torch.float64)
        dphi = hpx.ring_dphi(nr)
        phi = (jw.double() + 0.5 * sh[:, :, None]) * dphi[:, :, None]
        return pix, phi, valid, theta_r

    def slot_pix(self, i0_t, s_t, S_t):
        """Per-slot (pix int32, valid) (T, RB, K) of T tiles, integer
        math only (reference tiles.py:310-330)."""
        valid, j, _, sp, nr, _ = self._slots(i0_t, s_t, S_t)
        nr3 = nr[:, :, None]
        jw = torch.where(j < nr3, j, j - nr3)
        return sp[:, :, None] + jw, valid

    def slot_index(self, p):
        """Flat RING pixel ids (int32 tensor) -> linear slot index into the
        (n_tiles * RB * K) tile-major layout, closed-form int32 math
        (reference tiles.py:332-381; valid for NSIDE <= 8192). The cap-ring
        square root runs in float64 on the raw pixel id."""
        N, RB, K = self.nside, self.RB, self.K
        arr = self.device_arrays(p.device)
        p = p.to(torch.int32)
        ncap = 2 * N * (N - 1)
        npx = 12 * N * N

        i_n = hpx._cap_ring(p)
        j_n = p - 2 * i_n * (i_n - 1)

        pe = p - ncap
        i_e = N + torch.div(pe, 4 * N, rounding_mode="floor")
        j_e = pe % (4 * N)

        ps = (npx - 1) - p
        i_ss = hpx._cap_ring(ps)
        j_s = 4 * i_ss - 1 - (ps - 2 * i_ss * (i_ss - 1))

        north = p < ncap
        south = p >= npx - ncap
        i = torch.where(north, i_n, torch.where(south, 4 * N - i_ss, i_e))
        j = torch.where(north, j_n, torch.where(south, j_s, j_e))
        nr = torch.where(north, 4 * i_n,
                         torch.where(south, 4 * i_ss,
                                     torch.full_like(i, 4 * N)))
        sh = ((north | south) | ((i - N) % 2 == 0)).to(torch.int32)

        b = torch.div(i - 1, RB, rounding_mode="floor")
        u = (i - 1) - b * RB
        S = arr["S"][b.long()]
        off = arr["tile_off"][b.long()]
        s = torch.div((2 * j + sh) * S, 2 * nr, rounding_mode="floor")
        v = j - _j0(s, nr, sh, S)
        return ((off + s) * RB + u) * K + v

    # -- slot <-> RING re-layout: kernel K7 -----------------------------
    def _check_layout(self, x, lead, name):
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: unsupported dtype {x.dtype}")
        trail = tuple(x.shape[len(lead):])
        if tuple(x.shape[:len(lead)]) != lead or trail not in ((), (1,),
                                                               (2,)):
            raise ValueError(f"{name}: need shape {lead} + (), (1,) or "
                             f"(2,), not {tuple(x.shape)}")
        return trail

    def flat_view_plain(self, acc):
        """Plain version of :meth:`flat_view`: a gather at the slot index of
        every pixel, in pixel chunks."""
        trail = self._check_layout(acc, (self.n_tiles, self.P), "flat_view")
        flat_slots = acc.reshape((self.n_tiles * self.P,) + trail)
        npx = self.npix
        out = torch.empty((npx,) + trail, dtype=acc.dtype, device=acc.device)
        for start in range(0, npx, _PIX_CHUNK):
            stop = min(start + _PIX_CHUNK, npx)
            lin = self.slot_index(torch.arange(start, stop, dtype=torch.int32,
                                               device=acc.device))
            out[start:stop] = flat_slots[lin.long()]
        return out

    def tile_view_plain(self, flat):
        """Plain version of :meth:`tile_view`: a gather at every slot's
        pixel, dead slots 0, in tile chunks."""
        trail = self._check_layout(flat, (self.npix,), "tile_view")
        arr = self.device_arrays(flat.device)
        out = torch.zeros((self.n_tiles, self.P) + trail, dtype=flat.dtype,
                          device=flat.device)
        for t0 in range(0, self.n_tiles, _TILE_CHUNK):
            t1 = min(t0 + _TILE_CHUNK, self.n_tiles)
            pix, valid = self.slot_pix(arr["tile_i0"][t0:t1],
                                       arr["tile_s"][t0:t1],
                                       arr["tile_S"][t0:t1])
            n = t1 - t0
            valid = valid.reshape(n, self.P)
            vals = flat[torch.where(valid, pix.reshape(n, self.P), 0).long()]
            mask = valid.reshape(valid.shape + (1,) * len(trail))
            out[t0:t1] = torch.where(mask, vals, torch.zeros_like(vals))
        return out

    def flat_view(self, acc):
        """Tile-major (n_tiles, P[, C]) -> flat RING order (npix[, C]),
        C = 1 or 2: every pixel reads its slot (reference tiles.py:425-461).
        Kernel K7 for tensors on CUDA, the plain version on the CPU."""
        trail = self._check_layout(acc, (self.n_tiles, self.P), "flat_view")
        if acc.device.type == "cpu":
            return self.flat_view_plain(acc)
        out = torch.empty((self.npix,) + trail, dtype=acc.dtype,
                          device=acc.device)
        self._launch_layout("flat_view", acc, out, trail)
        return out

    def tile_view(self, flat):
        """Flat RING order (npix[, C]) -> tile-major (n_tiles, P[, C]),
        dead slots 0 (reference tiles.py:384-423). Kernel K7 for tensors on
        CUDA, the plain version on the CPU."""
        trail = self._check_layout(flat, (self.npix,), "tile_view")
        if flat.device.type == "cpu":
            return self.tile_view_plain(flat)
        out = torch.empty((self.n_tiles, self.P) + trail, dtype=flat.dtype,
                          device=flat.device)
        self._launch_layout("tile_view", flat, out, trail)
        return out

    def _launch_layout(self, name, src, out, trail):
        if src.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {src.device}")
        arr = self.device_arrays(src.device)
        src = src.contiguous()
        C = trail[0] if trail else 1
        fn = getattr(_build.library(), "bf_{}_{}".format(
            name, "f32" if src.dtype == torch.float32 else "f64"))
        with torch.cuda.device(src.device):
            err = fn(self.nside, self.RB, self.K, self.n_tiles,
                     _build.ptr(arr["tile_i0"]), _build.ptr(arr["tile_s"]),
                     _build.ptr(arr["tile_S"]), C, _build.ptr(src),
                     _build.ptr(out), _build.stream_of(src))
        _build.check(err, name)
        _build.count(name)


def _ring_theta_np(N, i):
    """Host-side ring colatitude for (possibly fractional) ring index."""
    i = np.asarray(i, dtype=float)
    i_s = 4 * N - i
    th_n = 2.0 * np.arcsin(np.clip(i / (np.sqrt(6.0) * N), 0, 1))
    th_s = np.pi - 2.0 * np.arcsin(np.clip(i_s / (np.sqrt(6.0) * N), 0, 1))
    z_e = 4.0 / 3.0 - 2.0 * i / (3.0 * N)
    th_e = np.arccos(np.clip(z_e, -1, 1))
    return np.where(i < N, th_n, np.where(i > 3 * N, th_s, th_e))


def _ring_of_theta_np(N, theta):
    """Host-side ring_above + 1 style ring index of a colatitude."""
    theta = np.clip(theta, 0.0, np.pi)
    z = np.cos(theta)
    polar = np.abs(z) > 2.0 / 3.0
    rt6N = np.sqrt(6.0) * N
    irn = np.floor(rt6N * np.sin(0.5 * theta)).astype(np.int64)
    irs = np.floor(rt6N * np.cos(0.5 * theta)).astype(np.int64)
    ring_pol = np.where(z > 0, irn, 4 * N - irs - 1)
    ring_eq = np.floor(N * (2.0 - 1.5 * z)).astype(np.int64)
    return np.where(polar, ring_pol, ring_eq)


def bin_halos_to_tiles(tiling, theta, phi, radius, margin_pix=2.0):
    """Host-side (tile_id, halo_id) int32 pairs for every tile each halo's
    disc (angular radius ``radius``) may touch, by the disc's theta band x
    phi window, widened by ``margin_pix`` pixel widths (reference
    tiles.py:488-563; the window math is float32, the ring bracketing
    float64)."""
    N = tiling.nside
    RB = tiling.RB
    theta = np.asarray(theta, float)
    phi = np.mod(np.asarray(phi, float), 2 * np.pi)
    radius = np.asarray(radius, float)
    n = theta.size

    i_lo = np.clip(_ring_of_theta_np(N, theta - radius), 1, 4 * N - 1)
    i_hi = np.clip(_ring_of_theta_np(N, theta + radius) + 1, 1, 4 * N - 1)
    b_lo = ((i_lo - 1) // RB).astype(np.int32)
    b_hi = ((i_hi - 1) // RB).astype(np.int32)
    max_d = int((b_hi - b_lo).max()) + 1 if n else 0

    theta32 = theta.astype(np.float32)
    rad32 = radius.astype(np.float32)
    phi32 = phi.astype(np.float32)
    blk_lo32 = tiling.block_th_lo.astype(np.float32)
    blk_hi32 = tiling.block_th_hi.astype(np.float32)
    S_all = tiling.S.astype(np.int32)
    tile_off32 = tiling.tile_off.astype(np.int32)

    tiles_all, halos_all = [], []
    sin_r = np.sin(np.minimum(rad32, np.float32(0.5 * np.pi)))
    for d in range(max_d):
        b = b_lo + d
        act = b <= b_hi
        if not act.any():
            continue
        idx = np.where(act)[0].astype(np.int32)
        bb = b[idx]
        t_lo = np.maximum(theta32[idx] - rad32[idx], blk_lo32[bb])
        t_hi = np.minimum(theta32[idx] + rad32[idx], blk_hi32[bb])
        sin_min = np.minimum(np.sin(t_lo), np.sin(t_hi))
        touches_pole = (t_lo <= 1e-9) | (t_hi >= np.float32(np.pi) - 1e-6)
        w = np.where(
            (sin_min <= sin_r[idx]) | touches_pole, np.float32(np.pi),
            np.arcsin(np.clip(sin_r[idx]
                              / np.maximum(sin_min, np.float32(1e-12)),
                              0, 1)))
        S = S_all[bb]
        dphi_sec = np.float32(2 * np.pi) / S
        w = np.minimum(w + np.float32(margin_pix * np.pi / (2.0 * N))
                       / np.maximum(sin_min, np.float32(1e-3)),
                       np.float32(np.pi))
        s_lo = np.floor((phi32[idx] - w) / dphi_sec).astype(np.int32)
        s_hi = np.floor((phi32[idx] + w) / dphi_sec).astype(np.int32)
        cnt = np.minimum(s_hi - s_lo + 1, S)
        rep_h = np.repeat(idx, cnt)
        rep_b = np.repeat(bb, cnt)
        rep_s0 = np.repeat(s_lo, cnt)
        rep_S = np.repeat(S, cnt)
        csum = np.cumsum(cnt, dtype=np.int64)
        pos = (np.arange(csum[-1], dtype=np.int32)
               - np.repeat((csum - cnt).astype(np.int32), cnt))
        s = np.mod(rep_s0 + pos, rep_S)
        tiles_all.append(tile_off32[rep_b] + s)
        halos_all.append(rep_h)
    if not tiles_all:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    return np.concatenate(tiles_all), np.concatenate(halos_all)


def refine_pairs(tiling, tile_ids, halo_ids, vh, chord_rad):
    """Exact pair pruning (host; reference tiles.py:566-612): a pair whose
    tile lies farther from the halo than its circumradius plus the disc's
    chord ``chord_rad`` cannot pass the deposit's chord2 <= crit2 mask, so
    dropping it changes no value. Returns the kept (tile_ids, halo_ids),
    and counts the pairs (``pairs``) and those kept (``pairs_kept``).

    The JAX function also sorts the kept pairs into far and near classes
    for its windowed curve sweep; the port runs the full sweep on every
    pair, which is the JAX function's "near" result with no
    classification."""
    crad = tiling.tile_crad.astype(np.float32)[tile_ids]
    d = (tiling.tile_center.astype(np.float32)[tile_ids]
         - np.asarray(vh, np.float32)[halo_ids])
    dcen = np.sqrt(np.einsum("ij,ij->i", d, d))
    lo = dcen - crad
    keep = lo <= np.asarray(chord_rad, np.float32)[halo_ids] + 1e-5
    tile_ids, halo_ids = tile_ids[keep], halo_ids[keep]
    trace.count("pairs", keep.size)
    trace.count("pairs_kept", tile_ids.size)
    return tile_ids, halo_ids


def pairs_csr(tile_ids, halo_ids):
    """Group (tile, halo) pairs per tile: (tiles (T,) int32 ascending,
    offsets (T + 1,) int32, halos (n_pairs,) int32), the halos of
    ``tiles[k]`` being ``halos[offsets[k]:offsets[k + 1]]`` in their input
    order (the stable tile sort of the reference's bucket_tiles,
    tiles.py:1202-1253, without its padded static shapes)."""
    order = np.argsort(np.asarray(tile_ids).astype(np.int32), kind="stable")
    t_sorted = np.asarray(tile_ids)[order]
    h_sorted = np.asarray(halo_ids)[order].astype(np.int32)
    if t_sorted.size == 0:
        return (np.zeros(0, np.int32), np.zeros(1, np.int32), h_sorted)
    bnd = np.empty(t_sorted.size, dtype=bool)
    bnd[0] = True
    np.not_equal(t_sorted[1:], t_sorted[:-1], out=bnd[1:])
    starts = np.flatnonzero(bnd)
    offsets = np.append(starts, t_sorted.size).astype(np.int32)
    return t_sorted[starts].astype(np.int32), offsets, h_sorted


def valid_slot_counts(tiling, tids):
    """Host-side number of valid pixel slots of each tile in ``tids``
    (integer ring math, as ``SkyTiling.slot_pix``)."""
    N = tiling.nside
    RB = tiling.RB
    i0 = tiling.tile_i0[tids].astype(np.int64)
    s = tiling.tile_s[tids].astype(np.int64)
    S = tiling.tile_S[tids].astype(np.int64)
    i = i0[:, None] + np.arange(RB, dtype=np.int64)[None, :]
    ring_ok = (i >= 1) & (i <= 4 * N - 1)
    i_c = np.clip(i, 1, 4 * N - 1)
    north = i_c < N
    south = i_c > 3 * N
    i_s = 4 * N - i_c
    nr = np.where(north, 4 * i_c, np.where(south, 4 * i_s, 4 * N))
    sh = np.where(north | south, 1, np.where((i_c - N) % 2 == 0, 1, 0))
    j0 = (2 * s[:, None] * nr - sh * S[:, None]
          + 2 * S[:, None] - 1) // (2 * S[:, None])
    j1 = (2 * (s[:, None] + 1) * nr - sh * S[:, None]
          + 2 * S[:, None] - 1) // (2 * S[:, None])
    seg = np.minimum(j1 - j0, tiling.K)
    return np.where(ring_ok, seg, 0).sum(axis=1)


def count_valid_slots(tiling, tids):
    """Host-side exact count of valid pixel slots in the given tiles
    (reference tiles.py:1177-1199)."""
    return int(valid_slot_counts(tiling, tids).sum())


def stencil_host_info(tiling, W=2, Wc=5, i_min=128):
    """Host precompute for the stencil regrid (reference
    tiles.py:1269-1384).

    Returns a dict with the per-tile neighbour table ``nbr`` (n_tiles, 3, 3)
    int32 (-1 where unusable), the geometric scatter-source mask ``D_geom``
    (bad tiles dilated by one tile), the per-block offset thresholds
    ``th_theta`` / ``th_phi`` of the hot-tile test, ``sin_min``, and W, Wc.
    A block is bad within ``i_min`` rings of a pole, where segments are
    shorter than Wc, or where rings are too short for the slab window.
    """
    N = tiling.nside
    RB = tiling.RB
    nb = tiling.n_blocks
    n_rings = 4 * N - 1

    i0 = tiling.i0
    i_hi = np.minimum(i0 + RB - 1, n_rings)
    blk_bad = (i0 < i_min) | (i_hi > n_rings + 1 - i_min)
    K = tiling.K

    def nr_of(i):
        return np.where(i < N, 4 * i,
                        np.where(i > 3 * N, 4 * (4 * N - i), 4 * N))

    i_lo_m = np.clip(i0 - W - 1, 1, n_rings)
    i_hi_m = np.clip(i_hi + W + 1, 1, n_rings)
    nr_min_m = np.minimum(nr_of(i_lo_m), nr_of(i_hi_m))
    seg_min = nr_min_m // np.maximum(tiling.S, 1)
    blk_bad |= seg_min < Wc
    blk_bad |= nr_min_m < K + 2 * Wc
    S = tiling.S
    sameS_up = np.zeros(nb, bool)
    sameS_dn = np.zeros(nb, bool)
    sameS_up[1:] = S[1:] == S[:-1]
    sameS_dn[:-1] = S[:-1] == S[1:]

    tb = tiling.tile_block
    ts = tiling.tile_s
    tS = tiling.tile_S
    off = tiling.tile_off[:-1]

    nbr = np.full((tiling.n_tiles, 3, 3), -1, dtype=np.int32)
    for db in (-1, 0, 1):
        b2 = tb + db
        ok = (b2 >= 0) & (b2 < nb)
        if db == -1:
            ok &= sameS_up[tb]
        elif db == 1:
            ok &= sameS_dn[tb]
        for ds in (-1, 0, 1):
            s2 = np.mod(ts + ds, tS)
            tid2 = np.where(ok, off[np.clip(b2, 0, nb - 1)] + s2, -1)
            nbr[:, db + 1, ds + 1] = tid2

    tile_bad = blk_bad[tb]
    D_geom = tile_bad.copy()
    for db in range(3):
        for ds in range(3):
            n_ids = nbr[:, db, ds]
            valid = n_ids >= 0
            bad_nbr = np.zeros_like(tile_bad)
            bad_nbr[valid] = tile_bad[n_ids[valid]]
            D_geom |= bad_nbr
    miss_up = (nbr[:, 0, 1] < 0) & (tb > 0)
    miss_dn = (nbr[:, 2, 1] < 0) & (tb < nb - 1)
    edge = miss_up | miss_dn
    D_geom |= edge
    for db in range(3):
        for ds in range(3):
            n_ids = nbr[:, db, ds]
            valid = n_ids >= 0
            e_nbr = np.zeros_like(edge)
            e_nbr[valid] = edge[n_ids[valid]]
            D_geom |= e_nbr

    th_all = _ring_theta_np(N, np.arange(1, 4 * N))
    dth = np.diff(th_all)
    dth_blk = np.ones(nb) * dth.min()
    for b in range(nb):
        lo = max(int(i0[b]) - 2, 1) - 1
        hi = min(int(i_hi[b]) + 2, n_rings - 1)
        dth_blk[b] = dth[lo:hi].min() if hi > lo else dth.min()
    i_lo2 = np.clip(i0 - 2, 1, n_rings)
    i_hi2 = np.clip(i_hi + 2, 1, n_rings)
    nr_min = np.minimum(nr_of(i_lo2), nr_of(i_hi2))
    dphi_blk = 2.0 * np.pi / np.maximum(nr_min, 1)
    sin_min = np.minimum(np.sin(th_all[i_lo2 - 1]),
                         np.sin(th_all[i_hi2 - 1]))
    th_theta = (W - 1) * dth_blk
    th_phi = (Wc - 3) * dphi_blk * np.maximum(sin_min, 1e-12)

    return dict(nbr=nbr, D_geom=D_geom, th_theta=th_theta,
                th_phi=th_phi, sin_min=sin_min, W=W, Wc=Wc)
