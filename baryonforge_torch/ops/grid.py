"""The grid runners' cutout bodies: each halo's cutout of a periodic
Cartesian grid, displaced or painted.

``grid_cutout`` is the wrapper of kernel K15 (``csrc/grid_cutout.cu``);
``grid_cutout_plain`` is its plain version, a port of the three JAX
bodies (baryonforge_tpu/Runners/Map2DRunner.py: BaryonifyGrid 366-434,
PaintProfilesGrid 551-625, PaintProfilesAnisGrid 747-777, with
_cutout_geometry 276-289), vectorised over halo chunks and summed with
``index_add_``. On CUDA, ``cutout_tiles`` first lists each grid tile's
halos (the pair kernel, ``tile_pairs_plain`` its plain version, then one
sort), and K15 adds them tile by tile with no atomics.

Every halo of one call walks the same cutout of Ns^d cells, its size
bucket's largest Ns: offsets o = -w .. Ns - 1 - w (w = Ns // 2; Ns may be
odd) on each axis around its nearest grid centre ``cen``, wrapped mod N. Under the JAX package's x64 the
geometry is float64 whatever the runner's dtype: rel_d = o_d res + d_off_d
and r = |rel|, or |rel Rmat| for a 2D halo with ellipticity. The curve
values are in the curves' dtype T and read in float64. The modes:

  "displace"  d = the raw curve at max(r, 1e-30) rscale, 0 unless r < rmax,
              rounded to T, over res (pixel units), zeroed if not finite;
              per axis d T(rel_d / r) in float64, zeroed if not finite,
              rounded to T, added into the (ndim, N^d) offsets in T;
  "paint"     the curve at r (log curves exp'd), over a in 2D (projected
              curves hold Sigma a), added into the float64 map where finite
              and r < rmax;
  "anis"      painting and canvas, two curves at r each over a, non-finite
              values zeroed; mfrac = canvas / mtot[cell] (0 where mtot <=
              0) times orig[cell]; painting mfrac added where finite and
              r < rmax.

For models without ``halo_curves`` the bodies read the model itself on
every cell of the cutout (Map2DRunner.py:410, 584, 609, 757-759): kernel
K22 (``csrc/grid_cutout.cu``) has two entries for it. ``grid_radii``
writes each cutout cell's r, halo by halo, the cells row-major in the box,
the rows that ``ops.direct.readout`` reads the model on; ``grid_direct``
adds the model's values through K15's tile body and lists, in one launch
for all the halos given (the runner gives it several readout chunks at
once): displace at every cell of the box (the direct body has no r < rmax
cut; the caller passes rmax = inf, which also keeps every tile in the
lists), paint and anis where the value is finite and r < rmax. The tiles
the lists touch are compacted on the device (``touched_tiles``) and handed
out to a persistent grid by a counter, so no block is launched for an
untouched tile and no count is read back. ``grid_radii_plain`` and
``grid_direct_plain`` are their plain versions.
"""

import torch

from . import _build

__all__ = ["grid_cutout", "grid_cutout_plain", "cutout_tiles",
           "tile_pairs_plain", "touched_tiles", "grid_radii",
           "grid_radii_plain", "grid_direct", "grid_direct_plain", "TILE",
           "MODES"]

MODES = ("displace", "paint", "anis")

_CHUNK_CELLS = 1 << 22      # cutout cells per halo chunk of the plain version
# K15's tiles: cells a side by ndim (csrc/grid_cutout.cu kTile2, kTile3)
TILE = {2: 16, 3: 8}
_CHUNK_PAIRS = 1 << 24      # candidate (tile, halo) pairs per halo chunk


def _lookup(log_curve):
    if log_curve:
        from ..utils.Tabulate import TabulatedProfile
        return TabulatedProfile.curve_lookup
    from ..Profiles.BaryonCorrection import BaryonificationClass
    return BaryonificationClass.curve_lookup


def _geometry(npix, Ns, res, cen, doff, rmat):
    """Flat cell ids (n, K), per-axis relative positions [(n, K)] and r
    (n, K), float64, for halos with columns ``cen``, ``doff`` and ``rmat``
    (Map2DRunner.py:276-289, 370-392)."""
    n, ndim = cen.shape
    dev = cen.device
    offs = torch.arange(Ns, device=dev) - Ns // 2
    rel = [offs.double()[None, :] * res + doff[:, d, None]
           for d in range(ndim)]
    inds = [torch.remainder(cen[:, d, None].long() + offs[None, :], npix)
            for d in range(ndim)]
    shape = (n,) + (Ns,) * ndim
    g, flat = [], torch.zeros(shape, dtype=torch.long, device=dev)
    for d in range(ndim):
        view = [n] + [1] * ndim
        view[1 + d] = Ns
        g.append(rel[d].reshape(view).expand(shape).reshape(n, -1))
        flat = flat * npix + inds[d].reshape(view)
    if ndim == 2 and rmat is not None:
        xe = g[0] * rmat[:, 0, 0, None] + g[1] * rmat[:, 1, 0, None]
        ye = g[0] * rmat[:, 0, 1, None] + g[1] * rmat[:, 1, 1, None]
        r = torch.sqrt(xe * xe + ye * ye)
    else:
        r2 = g[0] * g[0] + g[1] * g[1]
        if ndim == 3:
            r2 = r2 + g[2] * g[2]
        r = torch.sqrt(r2)
    return flat.reshape(n, -1), g, r


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def grid_cutout_plain(mode, npix, Ns, res, halos, curve, acc, curve2=None,
                      a=1.0, mtot=None, orig=None):
    """Plain version of K15. Arguments as :func:`grid_cutout`."""
    curves, ln_r0, dlnr, log1 = curve
    n = curves.shape[0]
    ndim = halos["cen"].shape[1]
    dt = curves.dtype
    step = max(1, _CHUNK_CELLS // Ns ** ndim)
    for h0 in range(0, n, step):
        sl = slice(h0, min(n, h0 + step))
        rmat = halos["rmat"][sl] if halos.get("rmat") is not None else None
        flat, g, r = _geometry(npix, Ns, res, halos["cen"][sl],
                               halos["doff"][sl], rmat)
        rmax = halos["rmax"][sl, None]
        if mode == "displace":
            r_safe = torch.clamp(r, min=1e-30)
            d = _lookup(False)(curves[sl], ln_r0, dlnr,
                               r_safe * halos["rscale"][sl, None])
            d = torch.where(r < rmax, d, torch.zeros_like(d))
            d = _finite(d.to(dt).double() / res)
            for k in range(ndim):
                comp = _finite(d * (g[k] / r).to(dt).double())
                acc[k].index_add_(0, flat.reshape(-1),
                                  comp.to(dt).reshape(-1))
            continue
        if mode == "paint":
            v = _lookup(log1)(curves[sl], ln_r0, dlnr, r)
            if ndim == 2:
                v = v / a
        else:
            curves2, ln_r0_2, dlnr_2, log2 = curve2
            painting = _finite(_lookup(log1)(curves[sl], ln_r0, dlnr, r) / a)
            canvas = _finite(_lookup(log2)(curves2[sl], ln_r0_2, dlnr_2, r)
                             / a)
            mt = mtot[flat]
            v = painting * (torch.where(mt > 0, canvas / mt,
                                        torch.zeros_like(mt)) * orig[flat])
        keep = torch.isfinite(v) & (r < rmax)
        acc.index_add_(0, flat[keep], v[keep])
    return acc


def _axis_bounds(npix, Ns, res, cen, doff, T, K):
    """Per axis of each halo, the K tiles from the one holding its box's
    first cell, (n, ndim, K) tile indices, and a lower bound of |rel_d|
    over the box's cells in each, inf where the box misses the tile."""
    nt = -(-npix // T)
    w = Ns // 2
    first = torch.div(torch.remainder(cen - w, npix), T,
                      rounding_mode="floor")
    cand = torch.remainder(
        first[..., None] + torch.arange(K, device=cen.device), nt)
    lo_cell = cand * T
    hi_cell = torch.clamp(lo_cell + T, max=npix) - 1
    ostar = (-doff / res)[..., None]
    lb = torch.full(cand.shape, float("inf"), dtype=torch.float64,
                    device=cen.device)
    for k in (-1, 0, 1):          # the tile's copies one period apart
        lo = torch.clamp(lo_cell + k * npix - cen[..., None], min=-w)
        hi = torch.clamp(hi_cell + k * npix - cen[..., None], max=Ns - 1 - w)
        dist = torch.minimum((lo * res + doff[..., None]).abs(),
                             (hi * res + doff[..., None]).abs())
        dist = torch.where((lo <= ostar) & (ostar <= hi),
                           torch.zeros_like(dist), dist)
        lb = torch.where(lo <= hi, torch.minimum(lb, dist), lb)
    return cand, lb


def tile_pairs_plain(npix, Ns, res, halos, h0, m, K):
    """Plain version of K15's pair kernel: for halos h0 .. h0 + m - 1 and
    each one's K^d candidate tiles (K a side, from the tile of its box's
    first cell; halo-major, the last axis fastest), the pair's key, the
    row-major tile id or n_tiles where the pair is dropped, and the halo,
    both (m K^d,) int32."""
    sl = slice(h0, h0 + m)
    cen, doff = halos["cen"][sl].long(), halos["doff"][sl]
    ndim = cen.shape[1]
    T = TILE[ndim]
    nt = -(-npix // T)
    cand, lb = _axis_bounds(npix, Ns, res, cen, doff, T, K)
    tid, lb2 = cand[:, 0], lb[:, 0] ** 2
    for d in range(1, ndim):
        view = (m,) + (1,) * d + (K,)
        tid = tid[..., None] * nt + cand[:, d].reshape(view)
        lb2 = lb2[..., None] + lb[:, d].reshape(view) ** 2
    keep = torch.isfinite(lb2)
    if halos.get("rmat") is None:
        reach = (halos["rmax"][sl] + res) ** 2
        keep &= lb2 < reach.reshape((-1,) + (1,) * ndim)
    key = torch.where(keep, tid, nt ** ndim).reshape(-1).int()
    own = torch.arange(h0, h0 + m, dtype=torch.int32, device=cen.device)
    return key, own[:, None].expand(m, K ** ndim).reshape(-1)


def _tile_pairs_kernel(npix, Ns, res, halos, h0, m, K):
    """K15's pair kernel (``bf_tile_pairs``), as :func:`tile_pairs_plain`."""
    ndim = halos["cen"].shape[1]
    dev = halos["cen"].device
    key = torch.empty(m * K ** ndim, dtype=torch.int32, device=dev)
    own = torch.empty_like(key)
    cols = [halos[k].contiguous() for k in ("cen", "doff", "rmax")]
    with torch.cuda.device(dev):
        err = _build.library().bf_tile_pairs(
            ndim, npix, Ns, TILE[ndim], K, h0, m,
            *[_build.ptr(c) for c in cols[:2]], res, _build.ptr(cols[2]),
            int(halos.get("rmat") is None), _build.ptr(key),
            _build.ptr(own), _build.stream_of(key))
    _build.check(err, "tile_pairs")
    _build.count("tile_pairs")
    return key, own


def cutout_tiles(npix, Ns, res, halos):
    """K15's lists: the halos whose cutout may add to each tile of TILE[d]^d
    cells (row-major tile ids, the last tiles partial when TILE[d] does not
    divide N), as CSR on the halos' device. Returns (tile_start (n_tiles +
    1,) int32, tile_halo int32): tile t's halos, in ascending index, are
    tile_halo[tile_start[t]:tile_start[t + 1]] (entries past
    tile_start[-1] are dropped pairs).

    A (tile, halo) pair is listed when the halo's wrapped box of Ns^d cells
    meets the tile and, without ellipticity (``halos["rmat"]`` None), when
    the tile's box cells may hold r < rmax: the per-axis lower bounds of
    |rel_d| over them, squared and summed, under (rmax + res)^2. The pair
    keys come from K15's pair kernel on CUDA (its plain version on the
    CPU), then one stable sort by tile: nothing is read back to the host
    while the halos fit one chunk of _CHUNK_PAIRS candidate pairs."""
    n, ndim = halos["cen"].shape
    dev = halos["cen"].device
    T = TILE[ndim]
    nt = -(-npix // T)
    n_tiles = nt ** ndim
    K = min(nt, Ns // T + 3)      # tiles a box can meet on an axis
    if n == 0:
        return (torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    pairs = tile_pairs_plain if dev.type == "cpu" else _tile_pairs_kernel
    step = max(1, _CHUNK_PAIRS // K ** ndim)
    keys, owners = [], []
    for h0 in range(0, n, step):
        key, own = pairs(npix, Ns, res, halos, h0, min(step, n - h0), K)
        if step < n:            # several chunks: keep only listed pairs
            key, own = key[key < n_tiles], own[key < n_tiles]
        keys.append(key)
        owners.append(own)
    key, order = torch.sort(torch.cat(keys), stable=True)
    start = torch.searchsorted(key, torch.arange(
        n_tiles + 1, dtype=torch.int32, device=dev))
    return start.int(), torch.cat(owners)[order]


def touched_tiles(tile_start):
    """The tiles whose lists (``cutout_tiles``' CSR) are not empty, in
    ascending order, compacted on the lists' device with nothing read
    back: (tiles (n_tiles,) int32, its first n entries the touched tiles,
    work (2,) int32 on the device: n, then 0, the counter from which K22's
    apply hands the tiles out)."""
    hit = tile_start[1:] > tile_start[:-1]
    n_tiles = hit.numel()
    dev = tile_start.device
    pos = torch.cumsum(hit, 0, dtype=torch.int32)
    slot = torch.where(hit, pos - 1, n_tiles).long()
    tiles = torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev)
    tiles.scatter_(0, slot, torch.arange(n_tiles, dtype=torch.int32,
                                         device=dev))
    work = torch.zeros(2, dtype=torch.int32, device=dev)
    work[:1] = pos[-1:]
    return tiles[:n_tiles], work


def _check(mode, npix, Ns, halos, curve, acc, curve2, mtot, orig):
    if mode not in MODES:
        raise ValueError(f"grid_cutout: mode {mode!r} not in {MODES}")
    curves = curve[0]
    dev, dt = curves.device, curves.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"grid_cutout: unsupported curve dtype {dt}")
    n = curves.shape[0]
    cen = halos["cen"]
    if cen.dim() != 2 or cen.shape[0] != n or cen.shape[1] not in (2, 3) \
            or cen.dtype != torch.int32 or cen.device != dev:
        raise ValueError(f"grid_cutout: halos['cen'] must be an int32 ({n}, "
                         f"2 or 3) tensor on {dev}")
    ndim = cen.shape[1]
    want = {"doff": (n, ndim), "rmax": (n,), "rscale": (n,),
            "rmat": (n, 2, 2)}
    for k, shape in want.items():
        x = halos.get(k)
        if x is None and k in ("rmat", "rscale"):
            continue
        if x.dtype != torch.float64 or tuple(x.shape) != shape \
                or x.device != dev:
            raise ValueError(f"grid_cutout: halos[{k!r}] must be a float64 "
                             f"{shape} tensor on {dev}")
    if halos.get("rmat") is not None and ndim != 2:
        raise ValueError("grid_cutout: ellipticity is 2D only")
    if mode == "displace" and halos.get("rscale") is None:
        raise ValueError("grid_cutout: displace needs halos['rscale']")
    if not 2 <= Ns <= npix:
        raise ValueError(f"grid_cutout: cutout size {Ns} outside [2, {npix}]")
    nflat = npix ** ndim
    want_acc = ((ndim, nflat), dt) if mode == "displace" \
        else ((nflat,), torch.float64)
    if tuple(acc.shape) != want_acc[0] or acc.dtype != want_acc[1] \
            or acc.device != dev or not acc.is_contiguous():
        raise ValueError(f"grid_cutout: acc must be a contiguous "
                         f"{want_acc[1]} {want_acc[0]} tensor on {dev}")
    for c in (curve,) + ((curve2,) if mode == "anis" else ()):
        if c[0].dim() != 2 or c[0].shape[0] != n or c[0].shape[1] < 2 \
                or c[0].dtype != dt or c[0].device != dev:
            raise ValueError(f"grid_cutout: curves must be ({n}, n_r >= 2) "
                             f"{dt} tensors on {dev}")
    if mode == "anis":
        if ndim != 2:
            raise ValueError("grid_cutout: the anisotropic paint is 2D only")
        for name, x in (("mtot", mtot), ("orig", orig)):
            if x is None or x.dtype != torch.float64 \
                    or tuple(x.shape) != (nflat,) or x.device != dev:
                raise ValueError(f"grid_cutout: {name} must be a float64 "
                                 f"({nflat},) tensor on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"grid_cutout: unsupported device {dev}")


def grid_cutout(mode, npix, Ns, res, halos, curve, acc, curve2=None, a=1.0,
                mtot=None, orig=None):
    """Add every halo's cutout of a periodic N^d grid into ``acc``.

    mode   : "displace", "paint" or "anis" (see the module docstring)
    npix   : N, the grid's side in cells
    Ns     : the cutout's side in cells, the same for every halo (may be odd)
    res    : the grid's cell width
    halos  : dict of per-halo tensors: ``cen`` (n, ndim) int32 nearest grid
             centre, ``doff`` (n, ndim) float64 bins[cen] - pos, ``rmax``
             (n,) float64 (a cell counts where r < rmax), ``rscale`` (n,)
             float64 (displace only: the lookup's radius scale) and
             ``rmat`` (n, 2, 2) float64 2D shear matrices, or None
    curve  : (curves (n, n_r), ln_r0, dlnr, log_curves); the curves' dtype
             T (float32 or float64) is that of the displace offsets
    acc    : the accumulator, added into in place: (ndim, N^d) in T for
             displace, (N^d,) float64 otherwise
    curve2 : anis: the canvas' curve, in the same dtype
    a      : the scale factor: 2D paint and anis values are divided by it
             (projected curves hold Sigma a)
    mtot, orig : anis: the (N^d,) float64 total-mass canvas (background
             included) and input map

    Returns ``acc``. Kernel K15 for tensors on CUDA, the plain version for
    tensors on the CPU.
    """
    _check(mode, npix, Ns, halos, curve, acc, curve2, mtot, orig)
    curve = (curve[0], float(curve[1]), float(curve[2]), bool(curve[3]))
    if curve2 is not None:
        curve2 = (curve2[0], float(curve2[1]), float(curve2[2]),
                  bool(curve2[3]))
    dev = acc.device
    if dev.type == "cpu":
        return grid_cutout_plain(mode, npix, Ns, float(res), halos, curve,
                                 acc, curve2, float(a), mtot, orig)
    return _grid_cutout_kernel(mode, npix, Ns, float(res), halos, curve,
                               acc, curve2, float(a), mtot, orig)


def _grid_cutout_kernel(mode, npix, Ns, res, halos, curve, acc, curve2, a,
                        mtot, orig):
    """K15 on checked arguments: the (tile, halo) lists, then one block a
    tile."""
    n = curve[0].shape[0]
    if n == 0:
        return acc
    ndim = halos["cen"].shape[1]
    tile_start, tile_halo = cutout_tiles(npix, Ns, res, halos)
    rmat = halos.get("rmat")
    cols = [halos["cen"], halos["doff"], halos["rmax"], halos.get("rscale"),
            None if rmat is None else rmat.reshape(n, 4)]
    cols = [None if c is None else c.contiguous() for c in cols]
    curves1 = curve[0].contiguous()
    curves2 = None if curve2 is None else curve2[0].contiguous()
    c2 = curve2 if curve2 is not None else (None, 0.0, 1.0, False)

    def ptr(t):
        return None if t is None else _build.ptr(t)

    fn = getattr(_build.library(), "bf_grid_cutout_{}".format(
        "f32" if curves1.dtype == torch.float32 else "f64"))
    with torch.cuda.device(acc.device):
        err = fn(ndim, npix, Ns, TILE[ndim], MODES.index(mode),
                 ptr(tile_start), ptr(tile_halo), ptr(cols[0]),
                 ptr(cols[1]), res, ptr(cols[2]), ptr(cols[3]),
                 ptr(cols[4]), ptr(curves1), curves1.shape[1], curve[1],
                 curve[2], int(curve[3]), ptr(curves2),
                 2 if curves2 is None else curves2.shape[1], c2[1], c2[2],
                 int(c2[3]), a, ptr(mtot), ptr(orig), ptr(acc),
                 _build.stream_of(acc))
    _build.check(err, "grid_cutout")
    _build.count("grid_cutout")
    return acc


def grid_radii_plain(npix, Ns, res, halos):
    """Plain version of K22's radii pass. Arguments as :func:`grid_radii`."""
    return _geometry(npix, Ns, res, halos["cen"], halos["doff"],
                     halos.get("rmat"))[2].reshape(-1)


def grid_radii(npix, Ns, res, halos):
    """Each cutout cell's r for the direct readout.

    npix, Ns, res : as :func:`grid_cutout`
    halos  : ``cen`` (m, ndim) int32, ``doff`` (m, ndim) float64 and
             ``rmat`` ((m, 2, 2) float64 or None)

    Returns the (m Ns^d,) float64 radii, halo by halo, the cells of a box
    row-major (the last axis fastest), r = |rel| or |rel Rmat| as K15
    measures them. Kernel K22 (``bf_grid_radii``: a block a halo's plane,
    a thread a cell of a row) for tensors on CUDA, the plain version for
    tensors on the CPU.
    """
    cen, doff = halos["cen"], halos["doff"]
    m, ndim = cen.shape
    dev = cen.device
    if cen.dtype != torch.int32 or doff.dtype != torch.float64 \
            or tuple(doff.shape) != (m, ndim) or ndim not in (2, 3):
        raise ValueError("grid_radii: cen must be int32 (m, 2 or 3) and doff "
                         "float64 of its shape")
    rmat = halos.get("rmat")
    if dev.type == "cpu":
        return grid_radii_plain(npix, Ns, float(res), halos)
    if dev.type != "cuda":
        raise ValueError(f"grid_radii: unsupported device {dev}")
    if Ns > 65535 or Ns ** ndim >= 2 ** 31:
        raise ValueError(f"grid_radii: cutout of {Ns}^{ndim} cells too large")
    r = torch.empty(m * Ns ** ndim, dtype=torch.float64, device=dev)
    doff = doff.contiguous()
    rm = None if rmat is None else rmat.reshape(m, 4).contiguous()
    with torch.cuda.device(dev):
        err = _build.library().bf_grid_radii(
            ndim, Ns, m, _build.ptr(doff), float(res),
            None if rm is None else _build.ptr(rm), _build.ptr(r),
            _build.stream_of(r))
    _build.check(err, "grid_radii")
    _build.count("grid_radii")
    return r


def grid_direct_plain(mode, npix, Ns, res, halos, vals, acc, vals2=None,
                      mtot=None, orig=None):
    """Plain version of K22's apply. Arguments as :func:`grid_direct`."""
    m, ndim = halos["cen"].shape
    flat, g, r = _geometry(npix, Ns, res, halos["cen"], halos["doff"],
                           halos.get("rmat"))
    v = vals.reshape(m, -1)
    if mode == "displace":
        dt = acc.dtype
        d = _finite(v.double() / res)
        for k in range(ndim):
            comp = _finite(d * (g[k] / r).to(dt).double())
            acc[k].index_add_(0, flat.reshape(-1), comp.to(dt).reshape(-1))
        return acc
    if mode == "anis":
        mt = mtot[flat]
        canvas = _finite(vals2.reshape(m, -1))
        v = _finite(v) * (torch.where(mt > 0, canvas / mt,
                                      torch.zeros_like(mt)) * orig[flat])
    keep = torch.isfinite(v) & (r < halos["rmax"][:, None])
    acc.index_add_(0, flat[keep], v[keep])
    return acc


def grid_direct(mode, npix, Ns, res, halos, vals, acc, vals2=None, mtot=None,
                orig=None):
    """Add the model's values on :func:`grid_radii`'s rows into ``acc``.

    mode   : "displace", "paint" or "anis"
    halos  : as :func:`grid_cutout`'s, without ``rscale``; ``rmax`` inf for
             displace
    vals   : (m Ns^d,) the model's values on the rows: in the offsets'
             dtype T (displace) or float64
    acc    : (ndim, N^d) in T (displace) or (N^d,) float64, added into
    vals2, mtot, orig : anis: the canvas' values (float64), the (N^d,)
             float64 Mtot (background included) and input map

    Returns ``acc``. Kernel K22 (the cutout lists of K15, the touched
    tiles compacted, then ``bf_grid_direct``, a persistent grid over them)
    for tensors on CUDA, the plain version for tensors on the CPU. One call
    over halos 1..m equals calls over consecutive runs of them in turn,
    bit for bit: a tile adds its halos in ascending order.
    """
    if mode not in MODES:
        raise ValueError(f"grid_direct: mode {mode!r} not in {MODES}")
    m, ndim = halos["cen"].shape
    dev = acc.device
    n = m * Ns ** ndim
    want = acc.dtype if mode == "displace" else torch.float64
    for name, x in (("vals", vals),) + ((("vals2", vals2),)
                                         if mode == "anis" else ()):
        if x is None or x.dtype != want or x.shape != (n,) \
                or x.device != dev:
            raise ValueError(f"grid_direct: {name} must be a ({n},) {want} "
                             f"tensor on {dev}")
    if mode != "displace" and acc.dtype != torch.float64:
        raise ValueError("grid_direct: paint and anis maps are float64")
    if dev.type == "cpu":
        return grid_direct_plain(mode, npix, Ns, float(res), halos, vals, acc,
                                 vals2, mtot, orig)
    if dev.type != "cuda":
        raise ValueError(f"grid_direct: unsupported device {dev}")
    if m == 0:
        return acc
    tile_start, tile_halo = cutout_tiles(npix, Ns, res, halos)
    tiles, work = touched_tiles(tile_start)
    rmat = halos.get("rmat")
    cols = [halos["cen"].contiguous(), halos["doff"].contiguous(),
            halos["rmax"].contiguous(),
            None if rmat is None else rmat.reshape(m, 4).contiguous()]

    def ptr(t):
        return None if t is None else _build.ptr(t)

    fn = getattr(_build.library(), "bf_grid_direct_{}".format(
        "f32" if acc.dtype == torch.float32 else "f64"))
    with torch.cuda.device(dev):
        err = fn(ndim, npix, Ns, TILE[ndim], MODES.index(mode),
                 ptr(tile_start), ptr(tile_halo), ptr(tiles), ptr(work),
                 ptr(cols[0]), ptr(cols[1]), float(res), ptr(cols[2]),
                 ptr(cols[3]), ptr(vals), ptr(vals2), ptr(mtot), ptr(orig),
                 ptr(acc), _build.stream_of(acc))
    _build.check(err, "grid_direct")
    _build.count("grid_direct")
    return acc
