"""The grid runners' cutout bodies: each halo's cutout of a periodic
Cartesian grid, displaced or painted.

``grid_cutout`` is the wrapper of kernel K15 (``csrc/grid_cutout.cu``);
``grid_cutout_plain`` is its plain version, a port of the three JAX
bodies (baryonforge_tpu/Runners/Map2DRunner.py: BaryonifyGrid 366-434,
PaintProfilesGrid 551-625, PaintProfilesAnisGrid 747-777, with
_cutout_geometry 276-289), vectorised over halo chunks and summed with
``index_add_``.

Every halo of one call walks the same cutout of Ns^d cells, its size
bucket's largest Ns: offsets o = -Ns/2 .. Ns/2 - 1 on each axis around its
nearest grid centre ``cen``, wrapped mod N. Under the JAX package's x64 the
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
"""

import torch

from . import _build

__all__ = ["grid_cutout", "grid_cutout_plain", "MODES"]

MODES = ("displace", "paint", "anis")

_CHUNK_CELLS = 1 << 22      # cutout cells per halo chunk of the plain version


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
    Ns     : the cutout's side in cells, the same for every halo (even)
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
    n = curve[0].shape[0]
    if n == 0:
        return acc
    ndim = halos["cen"].shape[1]
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
    with torch.cuda.device(dev):
        err = fn(ndim, npix, Ns, n, MODES.index(mode), ptr(cols[0]),
                 ptr(cols[1]), float(res), ptr(cols[2]), ptr(cols[3]),
                 ptr(cols[4]), ptr(curves1), curves1.shape[1], curve[1],
                 curve[2], int(curve[3]), ptr(curves2),
                 2 if curves2 is None else curves2.shape[1], c2[1], c2[2],
                 int(c2[3]), float(a), ptr(mtot), ptr(orig), ptr(acc),
                 _build.stream_of(acc))
    _build.check(err, "grid_cutout")
    _build.launches["grid_cutout"] += 1
    return acc
