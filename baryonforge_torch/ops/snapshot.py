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

For models without ``halo_curves`` the JAX body reads ``model.displacement
(d, M_h, a)`` on each pair (SnapshotRunner.py:196). Kernel K23 has two
entries for it, both reading a :class:`DirectLayout` built once per pair
set (:func:`direct_layout`: the rows of ``ops.direct.row_layout`` over the
CSR rows, each row's first slot and width, the rows cut into pieces, one
(slot, halo) record per particle-major entry, and the positions in K17's
particle order with each pair's place in it). ``snapshot_radii``
writes each pair's float64 distance d into its slot of its row, the rows
``ops.direct.readout`` reads the model on; ``snapshot_direct`` is K17's
gather reading each entry's value from its slot: the value in T, zeroed
where not finite, times T(dx / d_safe). ``snapshot_radii_plain`` and
``snapshot_direct_plain`` are their plain versions.

The pairs may come in chunks of the halos, in ascending halo order, a
halo of more pairs than a chunk takes cut across chunks (the runner cuts a
snapshot's pairs by its ``PAIR_BUDGET``, :func:`pair_chunks`):
``snapshot_displace`` and ``snapshot_direct`` given ``acc`` continue each
particle's sum from it, so a run in chunks equals the one-chunk run bit for
bit.

Kernel K24 (``csrc/cell_list.cu``) finds the pairs on the card: a periodic
cell list built once per particle set and cell size (:func:`cell_build`),
a count pass over all the halos (:func:`cell_count`: each halo's pairs, as
int64 offsets on the host) and a write pass a chunk of halos
(:func:`cell_write`: the chunk's particles, grouped per halo). It finds the
sets of the port's host cell list (``native.cell_query``), with its cells
(:func:`cell_grid`) and its arithmetic; ``cell_query_plain`` is its plain
version, a brute-force minimum-image test.
"""

import collections

import numpy as np
import torch

from . import _build
from .direct import row_layout, row_width

__all__ = ["snapshot_displace", "snapshot_displace_plain",
           "snapshot_gather_plain", "particle_order", "particle_rank",
           "particle_major_plain", "particle_layout", "particle_major_pairs",
           "DirectLayout", "direct_layout", "RADII_PIECE", "snapshot_radii",
           "snapshot_radii_plain", "snapshot_direct",
           "snapshot_direct_plain", "pair_chunks", "cell_grid", "CellList",
           "cell_build", "CellQuery", "cell_count", "cell_write",
           "wrap_plain", "cell_query_plain"]

# pairs of a row a warp of K23's radii pass takes at most
RADII_PIECE = 256


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


def _start(acc, ndim, n_part, dt, dev):
    """The sums' start: ``acc`` itself (a chunk after earlier ones), or
    zeros."""
    if acc is None:
        return torch.zeros((ndim, n_part), dtype=dt, device=dev)
    if tuple(acc.shape) != (ndim, n_part) or acc.dtype != dt \
            or acc.device != dev:
        raise ValueError(f"acc must be ({ndim}, {n_part}) {dt} on {dev}")
    return acc


def snapshot_displace_plain(coords, hpos, halos, offsets, parts, curves,
                            ln_r0, dlnr, rscale, eps_edge, L, layout=None,
                            acc=None):
    """The halo-major reference: every pair at once, summed per particle by
    ``index_add_`` over the halo-major list. Arguments as
    :func:`snapshot_displace` (``layout`` is not read)."""
    dt, dev = curves.dtype, curves.device
    n_part, ndim = coords.shape
    acc = _start(acc, ndim, n_part, dt, dev)
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
                          ln_r0, dlnr, rscale, eps_edge, L, layout,
                          acc=None):
    """Plain version of K17: the pairs in the particle-major ``layout``,
    each particle's displacements summed from 0 (or from ``acc``) in its
    rows' order (the j-th row of every particle added in step j).
    Arguments as :func:`snapshot_displace`."""
    dt, dev = curves.dtype, curves.device
    n_part, ndim = coords.shape
    order, poff, prow = (x.long() for x in layout)
    acc = _start(acc, ndim, n_part, dt, dev)
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


def particle_rank(order):
    """Each particle's place in ``order`` (int32 (n_part,)), the inverse
    permutation."""
    n = order.numel()
    rank = torch.empty(n, dtype=torch.int32, device=order.device)
    rank[order.long()] = torch.arange(n, dtype=torch.int32,
                                      device=order.device)
    return rank


def particle_major_plain(offsets, parts, order, rank=None):
    """The particle-major copy of the halo-major pairs (offsets, parts),
    the particles taken in ``order`` (a permutation of them; ``rank`` its
    inverse, :func:`particle_rank`, formed here when None): (poff (n_part +
    1,), prow (P,)) int32, the halo-major rows of particle ``order[s]``
    being ``prow[poff[s]:poff[s + 1]]`` in ascending order (a stable sort of
    the pairs by their particle's place in ``order``). A layout step in
    torch on the pairs' device, not a kernel of its own: 4-byte rows and
    keys, and the sort's 8-byte indices."""
    dev = parts.device
    n_part = order.numel()
    if rank is None:
        rank = particle_rank(order)
    counts = (offsets[1:] - offsets[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(counts.numel(), dtype=torch.int32, device=dev), counts)
    key = torch.index_select(rank, 0, parts)
    prow = rows[torch.sort(key, stable=True).indices]
    del rows
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
                      dlnr, rscale, eps_edge, L, layout=None, acc=None):
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
    acc      : None, or the (ndim, n_part) offsets in T of the halos before
               these (a chunk of them): each particle's sum continues from
               its entry, written in place

    Returns the (ndim, n_part) offsets in T (``acc`` when given). Kernel
    K17 for tensors on CUDA, its plain version for tensors on the CPU.
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
                                     L, layout, acc)
    more = acc is not None
    acc = _start(acc, ndim, n_part, dt, dev) if more else torch.empty(
        (ndim, n_part), dtype=dt, device=dev)
    rec = _records(hpos, halos, rscale, eps_edge)
    sfx = "f32" if dt == torch.float32 else "f64"
    fn = getattr(_build.library(), f"bf_snapshot_displace_{sfx}")
    args = [x.contiguous() for x in (coords, *layout, halos, rec, curves)]
    with torch.cuda.device(dev):
        err = fn(ndim, n_part, float(L),
                 *[_build.ptr(x) for x in args], n_r, float(ln_r0),
                 float(dlnr), int(more), _build.ptr(acc),
                 _build.stream_of(acc))
    _build.check(err, "snapshot_displace")
    _build.count("snapshot_displace")
    return acc


def particle_major_pairs(parts, order, rank=None):
    """The halo-major pair index of every entry of the particle-major
    layout (int64 (P,)): the same stable sort of the pairs by their
    particle's place in ``order`` (``rank`` its inverse, formed here when
    None) as :func:`particle_major_plain` makes, so entry j's row is
    prow[j] and its pair this[j]."""
    if rank is None:
        rank = particle_rank(order)
    return torch.sort(torch.index_select(rank, 0, parts), stable=True).indices


DirectLayout = collections.namedtuple(
    "DirectLayout", ["rows", "slots", "pieces", "rec", "coords", "parts"])
DirectLayout.__doc__ = """K23's layout of one pair set, built once by
:func:`direct_layout`: ``rows`` the ``ops.direct.RowLayout`` of the
halo-major CSR rows (their pair counts), ``slots`` (R, 2) int32 each row's
first slot and width, ``pieces`` (n, 2) int32 the rows cut into runs of
at most RADII_PIECE pairs (row, first pair), ``rec`` (P, 2) int32 each
particle-major entry's (slot, halo), ``coords`` (n_part, ndim) float64 the
positions in K17's particle order and ``parts`` (P,) int32 each
halo-major pair's particle's place in that order (the kernels read the
positions there, neighbours side by side)."""


def direct_layout(coords, halos, offsets, parts, order, rank=None,
                  ordered=None):
    """K23's :class:`DirectLayout` of the halo-major pairs (halos, offsets,
    parts) of particles at ``coords``, the particle-major entries in
    ``order`` (K17's layout; ``rank`` its inverse and ``ordered`` the
    positions in it, formed here when None; a runner forms them once for
    all its chunks): one copy of the row counts to the host, then torch on
    the pairs' device. The records are int32: the runner's chunks of at
    most its PAIR_BUDGET pairs keep them far under 2^31; the check below
    guards a caller of its own."""
    dev = offsets.device
    counts = (offsets[1:] - offsets[:-1]).cpu().numpy().astype(np.int64)
    rows = row_layout(counts)
    if rows.n_slots >= np.iinfo(np.int32).max:
        raise ValueError(f"{rows.n_slots} readout slots in one chunk exceed "
                         "int32 records")
    slots = torch.as_tensor(np.stack([rows.base, row_width(counts)], 1)
                            .astype(np.int32), device=dev)
    n_pc = -(-counts // RADII_PIECE)
    first = np.repeat(np.cumsum(n_pc) - n_pc, n_pc)
    row_of = np.repeat(np.arange(counts.size, dtype=np.int64), n_pc)
    pieces = torch.as_tensor(np.stack(
        [row_of, (np.arange(row_of.size) - first) * RADII_PIECE], 1)
        .astype(np.int32), device=dev)
    row = torch.repeat_interleave(torch.arange(counts.size, device=dev),
                                  torch.as_tensor(counts, device=dev))
    slot = slots[:, 0].long()[row] + torch.arange(row.numel(), device=dev) \
        - offsets.long()[row]
    if rank is None:
        rank = particle_rank(order)
    pm = particle_major_pairs(parts, order, rank)
    rec = torch.stack((slot[pm], halos.long()[row[pm]]), 1).int()
    del slot, row, pm
    if ordered is None:
        ordered = coords[order.long()].contiguous()
    return DirectLayout(rows, slots, pieces, rec, ordered,
                        torch.index_select(rank, 0, parts))


def _min_image(coords, hpos, p, h, L):
    dx = coords[p] - hpos[h]
    dx = torch.where(dx > L / 2, dx - L, dx)
    return torch.where(dx < -L / 2, dx + L, dx)


def _distance(dx):
    d2 = dx[:, 0] * dx[:, 0]
    for c in range(1, dx.shape[1]):
        d2 = d2 + dx[:, c] * dx[:, c]
    return torch.sqrt(d2)


def snapshot_radii_plain(hpos, halos, offsets, dlay, L):
    """Plain version of K23's radii pass. Arguments and result as
    :func:`snapshot_radii`."""
    dev = offsets.device
    counts = (offsets[1:] - offsets[:-1]).long()
    row = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                  counts)
    slot = dlay.slots[:, 0].long()[row] + torch.arange(row.numel(),
                                                       device=dev) \
        - offsets.long()[row]
    r = torch.zeros(dlay.rows.n_slots, dtype=torch.float64, device=dev)
    dx = _min_image(dlay.coords, hpos, dlay.parts.long(), halos.long()[row],
                    L)
    r[slot] = _distance(dx)
    return r


def snapshot_radii(hpos, halos, offsets, dlay, L):
    """Each pair's minimum-image distance in its row, for the direct
    readout.

    hpos, halos, offsets, L : as :func:`snapshot_displace`
    dlay   : the pairs' :class:`DirectLayout`: the positions ``coords`` in
             K17's order and each pair's place ``parts`` in it

    Returns the (n_slots,) float64 distances, pair k of row i at slot
    ``dlay.slots[i, 0] + k``, the pads 0. Kernel K23 (``bf_snapshot_
    radii``: a warp a piece of a row) for tensors on CUDA, the plain
    version for tensors on the CPU.
    """
    dev = dlay.coords.device
    if dev.type == "cpu":
        return snapshot_radii_plain(hpos, halos, offsets, dlay, float(L))
    if dev.type != "cuda":
        raise ValueError(f"snapshot_radii: unsupported device {dev}")
    r = torch.empty(dlay.rows.n_slots, dtype=torch.float64, device=dev)
    args = [x.contiguous() for x in (dlay.coords, hpos, halos, offsets,
                                     dlay.parts, dlay.slots, dlay.pieces)]
    with torch.cuda.device(dev):
        err = _build.library().bf_snapshot_radii(
            dlay.coords.shape[1], dlay.pieces.shape[0], RADII_PIECE,
            float(L), *[_build.ptr(x) for x in args], _build.ptr(r),
            _build.stream_of(r))
    _build.check(err, "snapshot_radii")
    _build.count("snapshot_radii")
    return r


def snapshot_direct_plain(hpos, layout, dlay, vals, L, acc=None):
    """Plain version of K23's gather: each particle's entries summed from 0
    (or from ``acc``) in the particle-major order. Arguments as
    :func:`snapshot_direct`."""
    dt, dev = vals.dtype, vals.device
    n_part, ndim = dlay.coords.shape
    order, poff = layout[0].long(), layout[1].long()
    rec = dlay.rec.long()
    acc = _start(acc, ndim, n_part, dt, dev)
    counts = poff[1:] - poff[:-1]
    if rec.shape[0] == 0:
        return acc
    s = torch.repeat_interleave(torch.arange(n_part, device=dev), counts)
    dx = _min_image(dlay.coords, hpos, s, rec[:, 1], float(L))
    d = _distance(dx)
    d_safe = torch.where(d > 0, d, torch.ones_like(d))
    off = vals[rec[:, 0]]
    off = torch.where(torch.isfinite(off), off, torch.zeros_like(off))
    vec = off[:, None] * (dx / d_safe[:, None]).to(dt)
    start = poff[:-1]
    for j in range(int(counts.max())):
        live = torch.nonzero(counts > j)[:, 0]
        pj = order[live]
        acc[:, pj] = acc[:, pj] + vec[start[live] + j].T
    return acc


def snapshot_direct(hpos, layout, dlay, vals, L, acc=None):
    """Sum the model's per-pair displacements per particle.

    hpos, L : as :func:`snapshot_displace`
    layout : (order, poff) int32, the first two of K17's particle-major
             layout
    dlay   : the pairs' :class:`DirectLayout`: ``rec`` each particle-major
             entry's (slot in ``vals``, halo), ``coords`` the positions in
             ``order``
    vals   : (n_slots,) the model's displacement at each pair's distance,
             in T (float32 or float64)
    acc    : None, or the offsets of the halos before these, continued in
             place (as :func:`snapshot_displace`)

    Returns the (ndim, n_part) offsets in T (``acc`` when given). Kernel
    K23 (``bf_snapshot_direct``: a warp 32 particles, their entries 32 at a
    time) for tensors on CUDA, the plain version for tensors on the CPU.
    """
    dt, dev = vals.dtype, vals.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"snapshot_direct: unsupported dtype {dt}")
    n_part, ndim = dlay.coords.shape
    rec = dlay.rec
    if rec.dtype != torch.int32 or tuple(rec.shape) != (dlay.parts.numel(),
                                                        2):
        raise ValueError("snapshot_direct: rec must be int32 (P, 2), P the "
                         "pairs")
    if dev.type == "cpu":
        return snapshot_direct_plain(hpos, layout, dlay, vals, L, acc)
    if dev.type != "cuda":
        raise ValueError(f"snapshot_direct: unsupported device {dev}")
    more = acc is not None
    acc = _start(acc, ndim, n_part, dt, dev) if more else torch.empty(
        (ndim, n_part), dtype=dt, device=dev)
    args = [x.contiguous() for x in (dlay.coords, layout[0], layout[1], rec,
                                     hpos, vals)]
    fn = getattr(_build.library(), "bf_snapshot_direct_{}".format(
        "f32" if dt == torch.float32 else "f64"))
    with torch.cuda.device(dev):
        err = fn(ndim, n_part, float(L), *[_build.ptr(x) for x in args],
                 int(more), _build.ptr(acc), _build.stream_of(acc))
    _build.check(err, "snapshot_direct")
    _build.count("snapshot_direct")
    return acc


def pair_chunks(counts, budget):
    """Cut the halos, in index order, into runs whose pairs stay within
    ``budget``; a halo of more pairs than that is cut into runs of its own
    pairs (contiguous ranges of its halo-major pairs, in order, ``budget``
    each and the rest last). ``counts`` (n,) int the pairs a halo (int64
    totals). Returns the chunks [(h0, h1, p0, p1), ...]: halos [h0, h1)
    and their pairs [p0, p1) of the halo-major list (from 0 at halo 0); a
    run of a halo's own pairs has h1 = h0 + 1. They cover the halos 0 .. n
    and the pairs once, in order."""
    counts = np.asarray(counts, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(counts)])
    out = []
    h = 0
    while h < counts.size:
        if counts[h] > budget:
            out += [(h, h + 1, p0, min(p0 + budget, int(cum[h + 1])))
                    for p0 in range(int(cum[h]), int(cum[h + 1]), budget)]
            h += 1
            continue
        h1 = int(np.searchsorted(cum, cum[h] + budget, side="right")) - 1
        out.append((h, h1, int(cum[h]), int(cum[h1])))
        h = h1
    return out


def cell_grid(n_part, ndim, L, radii):
    """The cells of the port's host cell list (native/cell_list.cpp:42-73,
    native/__init__.py:92-95): about the median positive query radius a
    side, at most 256 an axis and about 8 a particle. Returns (ncell,
    cell)."""
    radii = np.asarray(radii, dtype=np.float64)
    pos_r = radii[radii > 0]
    size = float(np.median(pos_r)) if pos_r.size else float(L)
    root = np.cbrt if ndim == 3 else np.sqrt
    cap = min(256, int(root(8.0 * max(n_part, 1))) + 1)
    ncell = min(max(1, int(np.floor(L / size))), cap)
    return ncell, L / ncell


CellList = collections.namedtuple(
    "CellList", ["ndim", "L", "ncell", "cell", "start", "pos", "orig"])
CellList.__doc__ = """K24's cell list of one particle set on the card
(:func:`cell_build`): ``ncell`` cells an axis of side ``cell``, ``start``
(ncell^ndim + 1,) int64 each cell's first place, ``pos`` (n, ndim) float64
the positions wrapped into the box (np.mod) and ``orig`` (n,) int32 their
indices, cell by cell."""

CellQuery = collections.namedtuple(
    "CellQuery", ["centers", "radii", "win", "item_start", "item_off",
                  "items", "offsets"])
CellQuery.__doc__ = """K24's count pass over the halos (:func:`cell_count`):
on the card ``centers`` (n_h, ndim) float64 (wrapped), ``radii`` (n_h,),
``win`` (n_h, 4) int32 (the centre's cell an axis, the reach),
``item_start`` (n_h + 1,) int64 each halo's first item (a column of its
window), ``item_off`` (T + 1,) int64 each item's first pair; on the host
``items`` the halos' first items and ``offsets`` (n_h + 1,) int64 their
first pairs."""


def _cuda_only(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: K24 runs on CUDA tensors (the CPU runner "
                         "searches on the host, native.cell_query)")


def cell_build(coords, L, ncell):
    """K24's build: the periodic cell list of the particles at ``coords``
    ((n, ndim) float64 on the card, any values: wrapped into [0, L] as
    np.mod wraps them, bit for bit) with ``ncell`` cells an axis
    (:func:`cell_grid`). Two launches (a thread a particle: its cell and
    its place in it; then its position and index at that place) around a
    torch scan of the cells' counts. Returns the :class:`CellList`."""
    _cuda_only(coords, "cell_build")
    n, ndim = coords.shape
    if ndim not in (2, 3) or coords.dtype != torch.float64:
        raise ValueError("cell_build: coords must be (n, 2 or 3) float64")
    if not 1 <= ncell <= 256:
        raise ValueError(f"cell_build: {ncell} cells an axis")
    dev = coords.device
    coords = coords.contiguous()
    cell = L / ncell
    lib = _build.library()
    cid = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.zeros(ncell ** ndim, dtype=torch.int32, device=dev)
    stream = _build.stream_of(coords)
    with torch.cuda.device(dev):
        err = lib.bf_cell_bin(ndim, n, float(L), float(cell), ncell,
                              _build.ptr(coords), _build.ptr(cid),
                              _build.ptr(rank), _build.ptr(count), stream)
    _build.check(err, "cell_build")
    _build.count("cell_build")
    start = torch.zeros(count.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(count, 0, out=start[1:])
    del count
    pos = torch.empty_like(coords)
    orig = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.bf_cell_place(ndim, n, float(L), _build.ptr(coords),
                                _build.ptr(cid), _build.ptr(rank),
                                _build.ptr(start), _build.ptr(pos),
                                _build.ptr(orig), stream)
    _build.check(err, "cell_build")
    _build.count("cell_build")
    return CellList(ndim, float(L), int(ncell), cell, start, pos, orig)


def cell_count(cells, centers, radii):
    """K24's count pass: the pairs of every halo.

    cells   : the particles' :class:`CellList`
    centers : (n_h, ndim) halo positions, radii (n_h,) their query radii,
              host float64 (the centres wrapped here with np.mod, as the
              host list wraps them)

    Each halo's window (its centre's cell and reach = (long long)(r / cell)
    + 1 an axis, as the host list walks) is cut into items, a column of
    cells each, on the host; a warp an item counts its hits; the counts are
    scanned on the card. Returns the :class:`CellQuery`, whose host
    ``offsets`` (int64) give each halo's pairs."""
    L, ncell, cell, ndim = cells.L, cells.ncell, cells.cell, cells.ndim
    dev = cells.pos.device
    c = np.ascontiguousarray(np.mod(centers, L), dtype=np.float64)
    r = np.ascontiguousarray(radii, dtype=np.float64)
    n_h = r.size
    if c.shape != (n_h, ndim):
        raise ValueError(f"cell_count: centers must be ({n_h}, {ndim})")
    reach = np.minimum((r / cell).astype(np.int64) + 1, ncell)
    side = np.where(2 * reach + 1 >= ncell, ncell, 2 * reach + 1)
    items = np.zeros(n_h + 1, dtype=np.int64)
    np.cumsum(side ** (ndim - 1), out=items[1:])
    win = np.zeros((n_h, 4), dtype=np.int32)
    win[:, :ndim] = (np.fmod(c, L) / cell).astype(np.int64)
    win[:, 3] = reach
    dc, dr, dwin, dstart = (torch.as_tensor(x, device=dev)
                            for x in (c, r, win, items))
    T = int(items[-1])
    hits = torch.empty(T, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().bf_cell_count(
            ndim, 0, T, 0, n_h, float(L), ncell, _build.ptr(cells.start),
            _build.ptr(cells.pos), _build.ptr(dc), _build.ptr(dr),
            _build.ptr(dwin), _build.ptr(dstart), _build.ptr(hits),
            _build.stream_of(hits))
    _build.check(err, "cell_count")
    _build.count("cell_count")
    item_off = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    torch.cumsum(hits, 0, out=item_off[1:])
    offsets = item_off[dstart].cpu().numpy()
    return CellQuery(dc, dr, dwin, dstart, item_off, items, offsets)


def cell_write(cells, query, h0, h1):
    """K24's write pass: the particles (int32, their indices in the
    positions the list was built from) of halos [h0, h1), grouped per halo
    (the halo-major rows of :func:`ops.tiles.pairs_csr`, offsets
    ``query.offsets[h0:h1 + 1] - query.offsets[h0]``), in cell order within
    a row. A warp an item of the halos' windows."""
    base = int(query.offsets[h0])
    n = int(query.offsets[h1]) - base
    dev = cells.pos.device
    parts = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().bf_cell_write(
            cells.ndim, int(query.items[h0]), int(query.items[h1]), h0, h1,
            cells.L, cells.ncell, _build.ptr(cells.start),
            _build.ptr(cells.pos), _build.ptr(cells.orig),
            _build.ptr(query.centers), _build.ptr(query.radii),
            _build.ptr(query.win), _build.ptr(query.item_start),
            _build.ptr(query.item_off), base, _build.ptr(parts),
            _build.stream_of(parts))
    _build.check(err, "cell_write")
    _build.count("cell_write")
    return parts


def wrap_plain(x, L):
    """np.mod(x, L) (L > 0) in torch, bit for bit: fmod (exact), plus L
    where negative, +0 where 0."""
    m = torch.fmod(x, L)
    m = torch.where(m < 0, m + L, m)
    return torch.where(m == 0, torch.zeros_like(m), m)


def cell_query_plain(coords, L, centers, radii, block=1 << 24):
    """Plain version of K24: every (halo, particle) pair within the halo's
    radius, by a brute-force minimum-image test of every particle, the
    host list's arithmetic (positions and centres wrapped as np.mod, one
    wrap an axis, squares summed x, y, z from 0, d^2 <= r^2), about
    ``block`` (halo, particle) tests at a time.

    coords (n, ndim), centers (n_h, ndim), radii (n_h,) float64 tensors on
    one device. Returns (counts (n_h,) int64, offsets (n_h + 1,) int64,
    parts (P,) int32), each halo's particles in index order."""
    dev = coords.device
    pos = wrap_plain(coords, L)
    c = wrap_plain(centers, L)
    r2 = radii * radii
    n, ndim = pos.shape
    n_h = c.shape[0]
    pb = max(1, min(n, block))
    hb = max(1, block // max(n, 1))
    counts = torch.zeros(n_h, dtype=torch.int64, device=dev)
    parts = []
    for h0 in range(0, n_h, hb):
        h1 = min(n_h, h0 + hb)
        for p0 in range(0, n, pb):
            dx = pos[None, p0:p0 + pb] - c[h0:h1, None]
            dx = torch.where(dx > L / 2, dx - L, dx)
            dx = torch.where(dx < -L / 2, dx + L, dx)
            d2 = dx[..., 0] * dx[..., 0]
            for k in range(1, ndim):
                d2 = d2 + dx[..., k] * dx[..., k]
            del dx
            hit = d2 <= r2[h0:h1, None]
            counts[h0:h1] += hit.sum(1)
            parts.append((torch.nonzero(hit)[:, 1] + p0).to(torch.int32))
    offsets = torch.zeros(n_h + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=offsets[1:])
    return counts, offsets, (torch.cat(parts) if parts else
                             torch.zeros(0, dtype=torch.int32, device=dev))
