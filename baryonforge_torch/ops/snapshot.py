"""The snapshot displacement: every (halo, particle) pair of the neighbour
search displaced along its minimum-image direction, summed per particle.

``snapshot_displace`` is the wrapper of kernel K17 (``csrc/snapshot.cu``),
which replaces ``make_run`` / ``one_halo`` / ``body`` of the JAX package's
``Runners/SnapshotRunner.py:175-227``. The pairs come grouped per halo, as
``ops.tiles.pairs_csr`` groups them: (halos, offsets, parts), the
particles of halo ``halos[k]`` being ``parts[offsets[k]:offsets[k + 1]]``
(row k of the halo-major CSR, rows in ascending halo order). K17 reads them
particle-major, a layout built once per pair set (``particle_layout``):
(order, poff, prow), the particles in a space-filling order and the rows
of particle ``order[s]`` being ``prow[poff[s]:poff[s + 1]]`` in ascending
order. ``snapshot_displace_plain`` is the halo-major reference, the same
arithmetic as torch operations over all pairs at once;
``snapshot_gather_plain`` is K17's plain version, each particle's rows
summed in the particle-major layout's order.

Per pair, with T the curves' dtype (float32 or float64) and the JAX x64
promotions written out: the min-image offset dx and d = |dx| in float64;
r = T(d, or 1e-30 at d = 0) * rscale in T; the halo's curve read at r by
the log-uniform lerp of ``BaryonificationClass.curve_lookup`` in T; zero
unless T(d) < eps_edge, zero where not finite; the offset times T(dx / d)
added into the (ndim, n_part) accumulator in T.
"""

import torch

from . import _build

__all__ = ["snapshot_displace", "snapshot_displace_plain",
           "snapshot_gather_plain", "particle_order", "particle_major_plain",
           "particle_layout"]


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


def _pair_vectors(coords, hpos, h, p, curves, ln_r0, dlnr, rscale, eps_edge,
                  L):
    """The (pairs, ndim) displacement of each pair (halo h, particle p)
    in the curves' dtype."""
    dt = curves.dtype
    ndim = coords.shape[1]
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
    return off[:, None] * (dx / d_safe[:, None]).to(dt)


def snapshot_displace_plain(coords, hpos, halos, offsets, parts, curves,
                            ln_r0, dlnr, rscale, eps_edge, L, layout=None):
    """The halo-major reference: every pair at once, summed per particle by
    ``index_add_`` over the halo-major list. Arguments as
    :func:`snapshot_displace` (``layout`` is not read)."""
    dt, dev = curves.dtype, curves.device
    n_part, ndim = coords.shape
    acc = torch.zeros((ndim, n_part), dtype=dt, device=dev)
    counts = (offsets[1:] - offsets[:-1]).long()
    h = torch.repeat_interleave(halos.long(), counts)
    p = parts.long()
    if p.numel() == 0:
        return acc
    vec = _pair_vectors(coords, hpos, h, p, curves, ln_r0, dlnr, rscale,
                        eps_edge, L)
    for c in range(ndim):
        acc[c].index_add_(0, p, vec[:, c])
    return acc


def snapshot_gather_plain(coords, hpos, halos, offsets, parts, curves,
                          ln_r0, dlnr, rscale, eps_edge, L, layout):
    """Plain version of K17: the pairs in the particle-major ``layout``,
    each particle's displacements summed from 0 in its rows' order (the
    j-th row of every particle added in step j). Arguments as
    :func:`snapshot_displace`."""
    dt, dev = curves.dtype, curves.device
    n_part, ndim = coords.shape
    order, poff, prow = (x.long() for x in layout)
    acc = torch.zeros((ndim, n_part), dtype=dt, device=dev)
    counts = poff[1:] - poff[:-1]
    if prow.numel() == 0:
        return acc
    p = torch.repeat_interleave(order, counts)
    vec = _pair_vectors(coords, hpos, halos.long()[prow], p, curves, ln_r0,
                        dlnr, rscale, eps_edge, L)
    start = poff[:-1]
    for j in range(int(counts.max())):
        live = torch.nonzero(counts > j)[:, 0]
        pj = order[live]
        acc[:, pj] = acc[:, pj] + vec[start[live] + j].T
    return acc


def particle_order(coords, L):
    """The particles in a space-filling order: int32 permutation sorting
    them by the Morton (Z-order) index of their cell on a grid of 2^(30 //
    ndim) cells an axis across the periodic box, ties in index order."""
    n, ndim = coords.shape
    bits = 30 // ndim
    side = 1 << bits
    cell = torch.clamp((torch.remainder(coords, L) * (side / L)).long(), 0,
                       side - 1)
    key = torch.zeros(n, dtype=torch.int64, device=coords.device)
    for b in range(bits):
        for c in range(ndim):
            key |= ((cell[:, c] >> b) & 1) << (ndim * b + ndim - 1 - c)
    return torch.sort(key, stable=True).indices.to(torch.int32)


def particle_major_plain(offsets, parts, order):
    """The particle-major copy of the halo-major pairs (offsets, parts),
    the particles taken in ``order`` (a permutation of them): (poff
    (n_part + 1,), prow (P,)) int32, the halo-major rows of particle
    ``order[s]`` being ``prow[poff[s]:poff[s + 1]]`` in ascending order (a
    stable sort of the pairs by their particle's place in ``order``). A
    layout step in torch on the pairs' device, not a kernel of its own."""
    dev = parts.device
    n_part = order.numel()
    rank = torch.empty(n_part, dtype=torch.int64, device=dev)
    rank[order.long()] = torch.arange(n_part, device=dev)
    counts = (offsets[1:] - offsets[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                   counts)
    key = rank[parts.long()]
    prow = rows[torch.sort(key, stable=True).indices].to(torch.int32)
    poff = torch.zeros(n_part + 1, dtype=torch.int32, device=dev)
    poff[1:] = torch.cumsum(torch.bincount(key, minlength=n_part), 0)
    return poff, prow


def particle_layout(coords, L, offsets, parts):
    """K17's particle-major layout of the halo-major pairs: (order, poff,
    prow), order from :func:`particle_order`, (poff, prow) from
    :func:`particle_major_plain`."""
    order = particle_order(coords, L)
    return (order,) + particle_major_plain(offsets, parts, order)


def _records(hpos, halos, rscale, eps_edge):
    """Each halo-major row's record, as K17 reads it (``Record<T>`` in
    csrc/snapshot.cu): float64 rows of the halo's position (3 entries, the
    third 0 in 2D), then rscale and eps_edge, packed as two float32 in one
    float64 entry (4 a row, 32 bytes) or as two float64 and a pad (6 a row,
    48 bytes). Formed per halo, then gathered per row: three or four
    launches."""
    cols = [hpos]
    if hpos.shape[1] == 2:
        cols.append(hpos.new_zeros((hpos.shape[0], 1)))
    if rscale.dtype == torch.float32:
        cols.append(torch.stack((rscale, eps_edge), 1).view(torch.float64))
    else:
        cols.append(torch.stack((rscale, eps_edge,
                                 torch.zeros_like(rscale)), 1))
    return torch.cat(cols, 1).index_select(0, halos)


def snapshot_displace(coords, hpos, halos, offsets, parts, curves, ln_r0,
                      dlnr, rscale, eps_edge, L, layout=None):
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
    layout   : the pairs particle-major, (order, poff, prow) int32 as
               :func:`particle_layout` builds them; built here when None
               (the runner builds it once per pair set)

    Returns the (ndim, n_part) offsets in T. Kernel K17 for tensors on CUDA,
    its plain version for tensors on the CPU.
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"snapshot_displace: unsupported device {dev}")
    if layout is None:
        layout = particle_layout(coords, L, offsets, parts)
    for name, x, n in zip(("order", "poff", "prow"), layout,
                          (n_part, n_part + 1, parts.numel())):
        if tuple(x.shape) != (n,) or x.dtype != torch.int32 \
                or x.device != dev:
            raise ValueError(f"snapshot_displace: layout {name} must be "
                             f"({n},) int32 on {dev}")
    if dev.type == "cpu":
        return snapshot_gather_plain(coords, hpos, halos, offsets, parts,
                                     curves, ln_r0, dlnr, rscale, eps_edge,
                                     L, layout)
    acc = torch.empty((ndim, n_part), dtype=dt, device=dev)
    rec = _records(hpos, halos, rscale, eps_edge)
    sfx = "f32" if dt == torch.float32 else "f64"
    fn = getattr(_build.library(), f"bf_snapshot_displace_{sfx}")
    args = [x.contiguous() for x in (coords, *layout, halos, rec, curves)]
    with torch.cuda.device(dev):
        err = fn(ndim, n_part, float(L),
                 *[_build.ptr(x) for x in args], n_r, float(ln_r0),
                 float(dlnr), _build.ptr(acc), _build.stream_of(acc))
    _build.check(err, "snapshot_displace")
    _build.launches["snapshot_displace"] += 1
    return acc
