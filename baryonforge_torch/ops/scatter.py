"""The grid deposit: conservative unit-cell deposits on periodic grids.

``deposit_2d_plain`` and ``deposit_3d_plain`` port
``baryonforge_tpu.ops.scatter.deposit_2d`` and ``deposit_3d``: a unit
square (cube) at fractional position p overlaps its 2^d neighbouring cells
with per-axis weights (1 - frac, frac), p taken mod N with jnp.mod's
semantics (fmod moved into the divisor's sign), i0 = floor(p), i1 = (i0 +
1) mod N, and each corner gets value w_x w_y (w_z), multiplied left to
right.

``grid_deposit`` is the wrapper of kernel K16 (``csrc/grid_deposit.cu``):
BaryonifyGrid's regrid (Map2DRunner.py:447-466), every cell of the grid
moved from its lattice point by its offset and deposited so; its plain
version ``grid_deposit_plain`` builds the lattice plus offsets and calls
the plain deposits. K16 sums a tile of sources (``TILE``) into a window of
the tile in shared memory, grown by one cell on each side; corners outside
it go straight to the map, and the window is flushed into the map at the
end. ``grid_deposit_windows_plain`` does that bookkeeping in torch (not
the kernel's merge of neighbouring lanes' shared corners, which changes
only the order of the sums).
"""

import itertools

import torch

from . import _build

__all__ = ["deposit_2d_plain", "deposit_3d_plain", "grid_deposit",
           "grid_deposit_plain", "grid_deposit_windows_plain", "TILE"]

# K16's tile of sources a block, the last axis fastest (``Tile`` in
# csrc/grid_deposit.cu; bf_grid_deposit_tile reports the kernel's)
TILE = {2: (16, 64), 3: (8, 8, 32)}


def _jnp_mod(x, n):
    """jnp.mod on floats: fmod, moved into the divisor's sign."""
    r = torch.fmod(x, n)
    return torch.where((r != 0) & ((r < 0) != (n < 0)), r + n, r)


def _corner_weights_1d(pos, N):
    """(i0, i1, w0, w1) for a unit interval starting at ``pos`` on a
    periodic grid of size N (ops/scatter.py:17-25 of the JAX package)."""
    pos = _jnp_mod(pos, N)
    i0 = torch.floor(pos).to(torch.int32)
    frac = pos - i0.to(pos.dtype)
    i1 = torch.remainder(i0 + 1, N)
    i0 = torch.remainder(i0, N)
    return i0.long(), i1.long(), 1.0 - frac, frac


def deposit_2d_plain(grid, positions, values):
    """Deposit unit squares at ``positions`` (M, 2) with ``values`` (M,)
    onto a periodic (N, N) ``grid``; returns the updated grid (a new
    tensor)."""
    N = grid.shape[0]
    x0, x1, wx0, wx1 = _corner_weights_1d(positions[:, 0], N)
    y0, y1, wy0, wy1 = _corner_weights_1d(positions[:, 1], N)
    flat = grid.reshape(-1).clone()
    for xi, wxi in ((x0, wx0), (x1, wx1)):
        for yi, wyi in ((y0, wy0), (y1, wy1)):
            flat.index_add_(0, xi * N + yi, values * wxi * wyi)
    return flat.reshape(N, N)


def deposit_3d_plain(grid, positions, values):
    """Trilinear unit-cube deposit onto a periodic (N, N, N) grid; returns
    the updated grid (a new tensor)."""
    N = grid.shape[0]
    x0, x1, wx0, wx1 = _corner_weights_1d(positions[:, 0], N)
    y0, y1, wy0, wy1 = _corner_weights_1d(positions[:, 1], N)
    z0, z1, wz0, wz1 = _corner_weights_1d(positions[:, 2], N)
    flat = grid.reshape(-1).clone()
    for xi, wxi in ((x0, wx0), (x1, wx1)):
        for yi, wyi in ((y0, wy0), (y1, wy1)):
            for zi, wzi in ((z0, wz0), (z1, wz1)):
                flat.index_add_(0, (xi * N + yi) * N + zi,
                                values * wxi * wyi * wzi)
    return flat.reshape(N, N, N)


def lattice(npix, ndim, device):
    """The (ndim, npix^ndim) int64 lattice coordinates of the flat cells
    (row-major: the last axis fastest)."""
    ii = torch.arange(npix, device=device)
    if ndim == 2:
        return torch.stack([ii.repeat_interleave(npix), ii.repeat(npix)])
    return torch.stack([ii.repeat_interleave(npix * npix),
                        ii.repeat_interleave(npix).repeat(npix),
                        ii.repeat(npix * npix)])


def grid_deposit_plain(offsets, orig, npix, ndim):
    """Plain version of K16. Arguments as :func:`grid_deposit`."""
    rdt = orig.dtype
    po = torch.where(torch.isfinite(offsets), offsets,
                     torch.zeros_like(offsets)).to(rdt)
    pos = lattice(npix, ndim, orig.device).to(rdt) + po
    grid = torch.zeros((npix,) * ndim, dtype=rdt, device=orig.device)
    deposit = deposit_2d_plain if ndim == 2 else deposit_3d_plain
    return deposit(grid, pos.T, orig).reshape(-1)


def grid_deposit_windows_plain(offsets, orig, npix, ndim, tile=None,
                               counts=None):
    """K16's bookkeeping in torch, for any ``tile`` (K16's, ``TILE[ndim]``,
    by default): each source's corners as the plain deposits weight them;
    a corner whose value is exactly 0 skipped (adding +-0 to a map that
    starts at +0 changes no sum; a non-finite value times a zero weight is
    NaN, and kept); a corner inside its tile's window (the tile grown by one
    cell on each side, indices wrapped periodically) summed into the
    window, any other added into the map; then every nonzero window entry
    added into the map at its wrapped cell. Arguments and result as
    :func:`grid_deposit`. ``counts``, a dict, receives the numbers of
    sources, of sources whose offsets are all 0 (a non-finite one counting
    as 0), of corners kept, of those spilled past the window, and of window
    entries flushed."""
    tile = TILE[ndim] if tile is None else tuple(tile)
    rdt, dev, N = orig.dtype, orig.device, npix
    po = torch.where(torch.isfinite(offsets), offsets,
                     torch.zeros_like(offsets))
    lat = lattice(N, ndim, dev)
    pos = lat.to(rdt) + po.to(rdt)
    cw = [_corner_weights_1d(pos[d], N) for d in range(ndim)]
    nt = [-(-N // t) for t in tile]
    win = [t + 2 for t in tile]
    wvol = 1
    for w in win:
        wvol *= w
    tix = [lat[d] // tile[d] for d in range(ndim)]
    org = [torch.remainder(tix[d] * tile[d] - 1, N) for d in range(ndim)]
    tflat = tix[0]
    for d in range(1, ndim):
        tflat = tflat * nt[d] + tix[d]
    n_tiles = 1
    for n in nt:
        n_tiles *= n
    windows = torch.zeros(n_tiles * wvol, dtype=rdt, device=dev)
    out = torch.zeros(N ** ndim, dtype=rdt, device=dev)
    kept = spilled = 0
    for corner in itertools.product((0, 1), repeat=ndim):
        val, g, w = orig, 0, 0
        in_win = torch.ones_like(lat[0], dtype=torch.bool)
        for d, a in enumerate(corner):
            cell = cw[d][a]
            val = val * cw[d][2 + a]
            loc = torch.remainder(cell - org[d], N)
            g = g * N + cell
            w = w * win[d] + loc
            in_win &= loc < win[d]
        keep = val != 0
        spill = keep & ~in_win
        stay = keep & in_win
        windows.index_add_(0, (tflat * wvol + w)[stay], val[stay])
        out.index_add_(0, g[spill], val[spill])
        kept += int(keep.sum())
        spilled += int(spill.sum())
    ent = torch.nonzero(windows != 0)[:, 0]
    t_id, e = ent // wvol, ent % wvol
    le, tc = [None] * ndim, [None] * ndim
    for d in range(ndim - 1, -1, -1):
        le[d], e = e % win[d], e // win[d]
        tc[d], t_id = t_id % nt[d], t_id // nt[d]
    g = 0
    for d in range(ndim):
        g = g * N + torch.remainder(tc[d] * tile[d] - 1 + le[d], N)
    out.index_add_(0, g, windows[ent])
    if counts is not None:
        counts.update(sources=N ** ndim,
                      zero_offset=int((po == 0).all(0).sum()),
                      corners=kept, spilled=spilled, flushed=int(ent.numel()))
    return out


def grid_deposit(offsets, orig, npix, ndim):
    """Move every cell of a periodic N^d grid by its offset and deposit its
    value conservatively on the 2^d cells its unit square (cube) overlaps.

    offsets : (ndim, N^d) offsets in pixel widths, component-major, float32
              or float64 (non-finite values count as 0)
    orig    : (N^d,) flat map (row-major), float32 or float64: the
              deposit's dtype
    npix, ndim : N and d (2 or 3)

    Returns the (N^d,) new map in orig's dtype. Kernel K16 for tensors on
    CUDA, the plain version for tensors on the CPU.
    """
    if ndim not in (2, 3):
        raise ValueError(f"grid_deposit: ndim must be 2 or 3, not {ndim}")
    nflat = npix ** ndim
    dev = orig.device
    for name, x in (("offsets", offsets), ("orig", orig)):
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"grid_deposit: unsupported {name} dtype "
                            f"{x.dtype}")
    if tuple(offsets.shape) != (ndim, nflat) or offsets.device != dev:
        raise ValueError(f"grid_deposit: offsets must be ({ndim}, {nflat}) "
                         f"on {dev}")
    if tuple(orig.shape) != (nflat,):
        raise ValueError(f"grid_deposit: orig must be ({nflat},)")
    if dev.type == "cpu":
        return grid_deposit_plain(offsets, orig, npix, ndim)
    if dev.type != "cuda":
        raise ValueError(f"grid_deposit: unsupported device {dev}")
    if nflat >= 2 ** 31:
        raise ValueError("grid_deposit: more than 2^31 cells")
    out = torch.zeros(nflat, dtype=orig.dtype, device=dev)
    sfx = {torch.float32: "f32", torch.float64: "f64"}
    fn = getattr(_build.library(), "bf_grid_deposit_{}_{}".format(
        sfx[offsets.dtype], sfx[orig.dtype]))
    with torch.cuda.device(dev):
        err = fn(ndim, npix, _build.ptr(offsets.contiguous()),
                 _build.ptr(orig.contiguous()), _build.ptr(out),
                 _build.stream_of(out))
    _build.check(err, "grid_deposit")
    _build.launches["grid_deposit"] += 1
    return out
