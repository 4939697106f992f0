"""The snapshot displacement: every (halo, particle) pair of the neighbour
search displaced along its minimum-image direction, summed per particle.

``snapshot_displace`` is the wrapper of kernel K17 (``csrc/snapshot.cu``),
which replaces ``make_run`` / ``one_halo`` / ``body`` of the JAX package's
``Runners/SnapshotRunner.py:175-227``; ``snapshot_displace_plain`` is its
plain version, the same arithmetic as torch operations over all pairs at
once. The pairs come grouped per halo, as ``ops.tiles.pairs_csr`` groups
them: (halos, offsets, parts), the particles of halo ``halos[k]`` being
``parts[offsets[k]:offsets[k + 1]]``.

Per pair, with T the curves' dtype (float32 or float64) and the JAX x64
promotions written out: the min-image offset dx and d = |dx| in float64;
r = T(d, or 1e-30 at d = 0) * rscale in T; the halo's curve read at r by
the log-uniform lerp of ``BaryonificationClass.curve_lookup`` in T; zero
unless T(d) < eps_edge, zero where not finite; the offset times T(dx / d)
added into the (ndim, n_part) accumulator in T.
"""

import torch

from . import _build

__all__ = ["snapshot_displace", "snapshot_displace_plain"]

# the curve is staged in 48 KB of shared memory
_MAX_NR = 6144


def _lookup(curve_rows, ln_r0, dlnr, r):
    """curve_lookup of the JAX package in the dtype T of r and the curves:
    ln_r0 and dlnr rounded to T, as the JAX weak-typed scalars are."""
    dt, dev = r.dtype, r.device
    n_r = curve_rows.shape[-1]
    x = (torch.log(torch.clamp(r, min=1e-30))
         - torch.tensor(ln_r0, dtype=dt, device=dev)) \
        / torch.tensor(dlnr, dtype=dt, device=dev)
    i = torch.clamp(torch.floor(x).to(torch.int64), 0, n_r - 2)
    t = x - i.to(dt)
    c0 = torch.gather(curve_rows, 1, i[:, None])[:, 0]
    c1 = torch.gather(curve_rows, 1, i[:, None] + 1)[:, 0]
    out = c0 * (1 - t) + c1 * t
    return torch.where((x < 0) | (x > n_r - 1), torch.zeros_like(out), out)


def snapshot_displace_plain(coords, hpos, halos, offsets, parts, curves,
                            ln_r0, dlnr, rscale, eps_edge, L):
    """Plain version of K17. Arguments as :func:`snapshot_displace`."""
    dt, dev = curves.dtype, curves.device
    n_part, ndim = coords.shape
    acc = torch.zeros((ndim, n_part), dtype=dt, device=dev)
    counts = (offsets[1:] - offsets[:-1]).long()
    h = torch.repeat_interleave(halos.long(), counts)
    p = parts.long()
    if p.numel() == 0:
        return acc
    dx = coords[p] - hpos[h]
    dx = torch.where(dx > L / 2, dx - L, dx)
    dx = torch.where(dx < -L / 2, dx + L, dx)
    d2 = dx[:, 0] * dx[:, 0]
    for c in range(1, ndim):
        d2 = d2 + dx[:, c] * dx[:, c]
    d = torch.sqrt(d2)
    d_safe = torch.where(d > 0, d, torch.ones_like(d))
    d_l = torch.where(d > 0, d, torch.full_like(d, 1e-30)).to(dt)
    off = _lookup(curves[h], ln_r0, dlnr, d_l * rscale[h])
    zero = torch.zeros_like(off)
    off = torch.where(d.to(dt) < eps_edge[h], off, zero)
    off = torch.where(torch.isfinite(off), off, zero)
    vec = off[:, None] * (dx / d_safe[:, None]).to(dt)
    for c in range(ndim):
        acc[c].index_add_(0, p, vec[:, c])
    return acc


def snapshot_displace(coords, hpos, halos, offsets, parts, curves, ln_r0,
                      dlnr, rscale, eps_edge, L):
    """Sum every pair's displacement per particle.

    coords   : (n_part, ndim) float64 particle positions (ndim 2 or 3)
    hpos     : (n_halos, ndim) float64 halo positions
    halos, offsets, parts : the pairs grouped per halo (int32): the rows'
               halos (H,), their offsets (H + 1,) and the particles
    curves   : (n_halos, n_r) displacement curves on the log-uniform grid
               ln r = ln_r0 + i dlnr, float32 or float64: the dtype T
    rscale, eps_edge : (n_halos,) in T: the radius scale of the lookup and
               the cut (T(d) < eps_edge counts)
    L        : the periodic box size

    Returns the (ndim, n_part) offsets in T. Kernel K17 for tensors on CUDA,
    the plain version for tensors on the CPU.
    """
    dt, dev = curves.dtype, curves.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"snapshot_displace: unsupported dtype {dt}")
    if coords.ndim != 2 or coords.shape[1] not in (2, 3):
        raise ValueError("snapshot_displace: coords must be (n_part, 2 or 3)")
    n_part, ndim = coords.shape
    n_halos, n_r = curves.shape
    for name, x, shape, xdt in (
            ("coords", coords, (n_part, ndim), torch.float64),
            ("hpos", hpos, (n_halos, ndim), torch.float64),
            ("rscale", rscale, (n_halos,), dt),
            ("eps_edge", eps_edge, (n_halos,), dt),
            ("offsets", offsets, (halos.numel() + 1,), torch.int32)):
        if tuple(x.shape) != shape or x.dtype != xdt or x.device != dev:
            raise ValueError(f"snapshot_displace: {name} must be {shape} "
                             f"{xdt} on {dev}")
    for name, x in (("halos", halos), ("parts", parts)):
        if x.ndim != 1 or x.dtype != torch.int32 or x.device != dev:
            raise ValueError(f"snapshot_displace: {name} must be 1-D int32 "
                             f"on {dev}")
    if n_r < 2:
        raise ValueError("snapshot_displace: curves need 2 or more radii")
    if dev.type == "cpu":
        return snapshot_displace_plain(coords, hpos, halos, offsets, parts,
                                       curves, ln_r0, dlnr, rscale,
                                       eps_edge, L)
    if dev.type != "cuda":
        raise ValueError(f"snapshot_displace: unsupported device {dev}")
    if n_r > _MAX_NR:
        raise ValueError(f"snapshot_displace: at most {_MAX_NR} radii a "
                         "curve (staged in shared memory)")
    acc = torch.zeros((ndim, n_part), dtype=dt, device=dev)
    sfx = "f32" if dt == torch.float32 else "f64"
    fn = getattr(_build.library(), f"bf_snapshot_displace_{sfx}")
    args = [x.contiguous() for x in (coords, hpos, halos, offsets, parts,
                                     curves, rscale, eps_edge)]
    with torch.cuda.device(dev):
        err = fn(ndim, n_part, halos.numel(), float(L),
                 *[_build.ptr(x) for x in args[:6]], n_r, float(ln_r0),
                 float(dlnr), _build.ptr(args[6]), _build.ptr(args[7]),
                 _build.ptr(acc), _build.stream_of(acc))
    _build.check(err, "snapshot_displace")
    _build.launches["snapshot_displace"] += 1
    return acc
