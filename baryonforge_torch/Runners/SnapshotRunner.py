"""Particle snapshot runner: BaryonifySnapshot (2D and 3D periodic boxes).

Port of ``baryonforge_tpu.Runners.SnapshotRunner`` (reference
SnapshotRunner.py:162-275):

  host prep   per-halo R_Delta(M, a) at the snapshot's redshift, the query
              radii R_q = clip(eps R / a, 0, L / 2), the lookup's radius
              scale and the cut eps Rcom (numpy float64)
  neighbours  the (halo, particle) pairs within R_q, grouped per halo: on
              the card kernel K24's periodic cell list (ops/snapshot.
              cell_build once per runner and cell size, cell_count over
              every halo, cell_write a chunk), on the CPU the port's host
              cell list in 3D (``native``) and scipy's cKDTree in 2D. The
              halos are cut, in index order, into chunks of at most
              PAIR_BUDGET pairs, a halo of more pairs across chunks
              (ops/snapshot.pair_chunks: int64 totals on the host, int32
              rows within a chunk), and each chunk's pairs
              are laid out particle-major for K17 (ops/snapshot.
              particle_major_plain, a sort on the device, in the particle
              order made once per runner). The counts are kept, keyed by
              the catalog's content and the radii; the chunks too while
              the pairs stay within PAIR_CACHE_BYTES (a parameter sweep
              reuses them), else every call writes them anew
  K1          per-halo displacement curves at the single redshift
              (ops/interp.collapse_curves), in the runner's dtype
  K17         every chunk's pairs' displacement summed per particle
              (ops/snapshot.snapshot_displace), each chunk's sums going on
              from the chunks before it: a run in chunks is the one-chunk
              run bit for bit

then the host adds the offsets to the positions in float64 and wraps them
into [0, L]. A model without ``halo_curves`` takes the direct readout, as
the JAX body does: for each chunk, K23's radii pass (ops/snapshot.
snapshot_radii) writes each pair's distance into its halo's row (rows
grouped by their pair counts, ops/direct.row_layout), the model's
``displacement`` is read on them under ``torch.func.vmap`` (ops/direct.
readout, its tables in float64) and K23's gather (ops/snapshot.
snapshot_direct) adds the values per particle; it runs the whole catalog
on the runner's device, with or without a mesh. K23's layout (the rows,
each row's slots and pieces, each particle-major entry's (slot, halo)
record, each pair's place in K17's particle order: ops/snapshot.
direct_layout) is kept with the chunks, so a call on kept chunks reads
nothing back to the host between the pair cache and its result. The JAX
runner pads count buckets of halos to static shapes and scans them in
batches of at most 8,000,000 padded pairs (``n_size_buckets``,
``halo_batch``); here the pairs are exact lists and one launch covers a
chunk.

With a ``mesh`` (``parallel.halo_mesh``) the halos split into contiguous
shards, each cut into chunks by the same budget: each shard's chunks, with
their own particle-major layouts, go through K17 into their own offsets on
the shard's device and CUDA stream, summed in shard order on the runner's
device (``parallel.mesh.sharded_sum``).
"""

import hashlib

import numpy as np
import torch

from ..cosmo import core as _core
from ..cosmo import massdef as _massdef
from ..native import cell_query
from ..ops.direct import readout, readout_model, require
from ..ops.snapshot import (cell_build, cell_count, cell_grid, cell_write,
                            direct_layout, pair_chunks, particle_major_plain,
                            particle_order, particle_rank, snapshot_direct,
                            snapshot_displace, snapshot_radii)
from ..parallel.mesh import check_mesh, sharded_sum, to_device
from ..utils.trace import PhaseClock

__all__ = ["DefaultRunnerSnapshot", "BaryonifySnapshot", "PAIR_BUDGET",
           "PAIR_CACHE_BYTES"]

# The pairs a chunk holds at most. A chunk's transient device bytes a pair:
# about 36 on the curve path (the particle-major layout: int32 particles,
# rows and keys, the sort's int32 keys and int64 indices with their double
# buffers, the int32 particle-major rows) and about 100 on the direct path
# (K23's layout: int64 rows, slots and a second sort, its 8-byte records
# and 4-byte places; then the readout's float64 radii and values on up to
# 1.5 slots a pair). 2^28 pairs are ~10 GB and ~27 GB, within an 80 GB card
# beside a snapshot's own arrays, and keep a chunk's rows int32. A halo of
# more pairs is cut across chunks (on the card each of its chunks writes
# the halo's whole row first, 4 bytes a pair, and keeps its range).
PAIR_BUDGET = 1 << 28
# The chunks are kept with the counts while they cost at most this many
# device bytes: KEPT_PAIR_BYTES a pair (the int32 particles and
# particle-major rows, 8, and the direct path's 8-byte records and 4-byte
# places, 12) and 4 a particle a chunk (its particle-major offsets). Above
# it every call writes them anew.
PAIR_CACHE_BYTES = 1 << 34
KEPT_PAIR_BYTES = 20


class DefaultRunnerSnapshot:
    """Shared state for snapshot runners (reference SnapshotRunner.py).

    ``dtype`` is the curves' and the offsets' dtype (float32 by default);
    positions and distances are float64, as the JAX runner computes them
    under x64. ``device`` is where the kernels run: "cuda" by default, and it
    raises when CUDA is absent; the CPU runs the plain versions and must be
    asked for explicitly. ``KDTree_kwargs`` go to the 2D cKDTree (the CPU's
    search).

    ``mesh`` (a list of devices of the runner's device type,
    ``parallel.halo_mesh``) shards the halos (see the module docstring).
    ``halo_batch`` and ``n_size_buckets`` shape the JAX runner's padded
    static batches and do nothing here. ``verbose`` prints the direct
    readout's row groups.
    """

    def __init__(self, HaloNDCatalog, ParticleSnapshot, epsilon_max, model,
                 mass_def=_massdef.MassDef200c, verbose=True,
                 halo_batch=256, dtype=torch.float32, n_size_buckets=4,
                 KDTree_kwargs=None, mesh=None, device="cuda"):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be torch.float32 or torch.float64, "
                            f"not {dtype!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: device='cuda' but "
                               "CUDA is not available; pass device='cpu' "
                               "for the plain versions")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.mesh = mesh
        check_mesh(mesh, self.device)
        self.HaloNDCatalog = HaloNDCatalog
        self.ParticleSnapshot = ParticleSnapshot
        self.cosmo = HaloNDCatalog.cosmology
        self.model = model
        self.epsilon_max = epsilon_max
        self.mass_def = mass_def
        self.verbose = verbose
        self.halo_batch = halo_batch
        self.dtype = dtype
        self.n_size_buckets = n_size_buckets

        cols = ["x", "y"] if ParticleSnapshot.is2D else ["x", "y", "z"]
        self._coords = np.stack(
            [np.asarray(ParticleSnapshot.cat[c], dtype=float) for c in cols],
            axis=1)
        self._kdtree_kwargs = KDTree_kwargs or {}
        self._tree = None
        # made once per runner on its device: the positions, K17's particle
        # order (order, rank), the positions in it, K24's cell list
        self._coords_dev = None
        self._order = None
        self._ordered = None
        self._cells = None
        # (key, each halo's first pair (n_halos + 1,) int64 on the host,
        # the pairs' source (K24's CellQuery, or the host search's
        # particles), {n_shards: (budget, each shard's chunks), "direct":
        # (budget, each chunk's K23 layout)})
        self._pairs = None
        # milliseconds of each phase of the last process() call (see
        # PhaseClock): host_prep, neighbours, curves, displace, download;
        # radii, readout and apply instead of curves and displace for the
        # direct readout
        self.timings = {}

    @property
    def tree(self):
        """Lazy scipy cKDTree of the particles (the 2D neighbour search on
        the CPU; scipy.spatial is imported here, so that importing the
        package does not load it)."""
        if self._tree is None:
            from scipy.spatial import cKDTree
            L = self.ParticleSnapshot.L
            self._tree = cKDTree(np.mod(self._coords, L), boxsize=L,
                                 **self._kdtree_kwargs)
        return self._tree

    def _catalog_token(self):
        """Content digest (hex) of the halo catalog, so that an in-place
        change of it is seen. The particles are copied at construction: a
        new snapshot needs a new runner."""
        return hashlib.blake2b(
            np.ascontiguousarray(self.HaloNDCatalog.cat).tobytes(),
            digest_size=16).hexdigest()

    def invalidate(self):
        """Drop the cached neighbour pairs (process() re-keys on the
        catalog's content and the radii on every call, so this is rarely
        needed)."""
        self._pairs = None

    def _device_coords(self):
        if self._coords_dev is None:
            self._coords_dev = torch.as_tensor(self._coords,
                                               device=self.device)
        return self._coords_dev

    def _particle_order(self):
        """K17's particle order and its inverse (ops.snapshot.
        particle_order, particle_rank), made once per runner."""
        if self._order is None:
            order = particle_order(self._device_coords(),
                                   self.ParticleSnapshot.L)
            self._order = (order, particle_rank(order))
        return self._order

    def _pair_plan(self, hpos, R_q):
        """Count the (halo, particle) pairs within R_q, once per catalog
        content and radii: on the card K24 (its cell list built once per
        runner and cell size, then its count pass over every halo), on the
        CPU the host cell list (3D) or cKDTree (2D), the particles kept on
        the host. Sets ``_pairs``."""
        key = (self._catalog_token(),
               hashlib.blake2b(np.ascontiguousarray(R_q).tobytes(),
                               digest_size=16).hexdigest())
        if self._pairs is not None and self._pairs[0] == key:
            return
        self._pairs = None
        L = self.ParticleSnapshot.L
        if self.device.type == "cuda":
            coords = self._device_coords()
            ncell = cell_grid(coords.shape[0], coords.shape[1], L, R_q)[0]
            if self._cells is None or self._cells.ncell != ncell:
                self._cells = None
                self._cells = cell_build(coords, L, ncell)
            source = cell_count(self._cells, hpos, R_q)
            offsets = source.offsets
        else:
            if self.ParticleSnapshot.is2D:
                lists = self.tree.query_ball_point(np.mod(hpos, L), R_q)
                counts = np.array([len(x) for x in lists], dtype=np.int64)
                source = (np.concatenate([np.asarray(x, dtype=np.int32)
                                          for x in lists])
                          if counts.sum() else np.zeros(0, dtype=np.int32))
            else:
                counts, source = cell_query(self._coords, L, hpos, R_q)
            offsets = np.zeros(counts.size + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
        self._pairs = (key, offsets, source, {})

    def _chunk(self, h0, h1, p0, p1):
        """The pairs [p0, p1) of halos [h0, h1) (indices into the
        halo-major list; a halo cut across chunks gives a range of its own
        pairs) on the runner's device: the halo-major CSR (halos, offsets
        from 0, parts) int32, as ops.tiles.pairs_csr groups them (halos
        without pairs here have no row), and its particle-major layout
        (order, poff, prow). K24's write pass on the card (the halos'
        whole rows, cut to the range); a slice of the host search's
        particles on the CPU."""
        _, first, source, _ = self._pairs
        dev = self.device
        counts = np.diff(np.clip(first[h0:h1 + 1], p0, p1))
        rows = np.flatnonzero(counts)
        if dev.type == "cuda":
            parts = cell_write(self._cells, source, h0, h1)
            if p0 > first[h0] or p1 < first[h1]:
                parts = parts[p0 - first[h0]:p1 - first[h0]].clone()
        else:
            parts = torch.as_tensor(source[p0:p1])
        off = np.zeros(rows.size + 1, dtype=np.int64)
        np.cumsum(counts[rows], out=off[1:])
        halos = torch.as_tensor((rows + h0).astype(np.int32), device=dev)
        offsets = torch.as_tensor(off.astype(np.int32), device=dev)
        order, rank = self._particle_order()
        return ((halos, offsets, parts),
                (order,) + particle_major_plain(offsets, parts, order, rank))

    def _shard_chunks(self, n_shards):
        """Each shard's chunks (the halos np.array_split into ``n_shards``,
        each shard's pairs cut by PAIR_BUDGET, a halo of more pairs across
        chunks, chunks without pairs left out), as
        :meth:`_chunk` makes them: lists, kept with the pairs for this shard
        count and budget when they fit PAIR_CACHE_BYTES, else iterators that
        make each chunk when it is reached."""
        first, cache = self._pairs[1], self._pairs[3]
        got = cache.get(n_shards)
        if got is not None and got[0] == PAIR_BUDGET:
            return got[1]
        bounds = []
        for idx in np.array_split(np.arange(first.size - 1), n_shards):
            s0 = int(idx[0]) if idx.size else 0
            f0 = int(first[s0])
            bounds.append([(s0 + a, s0 + b, f0 + p0, f0 + p1)
                           for a, b, p0, p1 in pair_chunks(
                               np.diff(first[s0:s0 + idx.size + 1]),
                               PAIR_BUDGET) if p1 > p0])
        n_chunks = sum(len(b) for b in bounds)
        kept = (int(first[-1]) * KEPT_PAIR_BYTES
                + 4 * n_chunks * (len(self._coords) + 1))
        if kept > PAIR_CACHE_BYTES:
            return [(self._chunk(*c) for c in b) for b in bounds]
        out = [[self._chunk(*c) for c in b] for b in bounds]
        cache[n_shards] = (PAIR_BUDGET, out)
        return out

    def _neighbour_pairs(self, hpos, R_q):
        """The pairs within R_q as one chunk, (csr, layout) as
        :meth:`_chunk` makes them: the runner's own inputs to K17 for
        checks (:meth:`_one_chunk`)."""
        self._pair_plan(hpos, R_q)
        return self._one_chunk()

    def _one_chunk(self):
        """The counted pairs' only chunk; raises when they take more than
        one chunk of PAIR_BUDGET, or none."""
        chunks = list(self._shard_chunks(1)[0])
        if len(chunks) != 1:
            raise ValueError(f"the pairs take {len(chunks)} chunks of "
                             f"PAIR_BUDGET = {PAIR_BUDGET}, not one")
        return chunks[0]

    def _with_direct(self, chunk):
        """``chunk`` with K23's layout of its pairs (ops.snapshot.
        direct_layout, in the runner's particle order)."""
        (halos, offsets, parts), layout = chunk
        order, rank = self._particle_order()
        if self._ordered is None:
            self._ordered = self._device_coords()[order.long()].contiguous()
        return chunk + (direct_layout(self._device_coords(), halos, offsets,
                                      parts, order, rank, self._ordered),)

    def _direct_chunks(self):
        """Each chunk (no mesh) with K23's layout: kept with the pairs when
        the chunks are (the layouts built at the first direct call on
        them), else made as they are reached."""
        chunks = self._shard_chunks(1)[0]
        if not isinstance(chunks, list):
            return (self._with_direct(c) for c in chunks)
        cache = self._pairs[3]
        got = cache.get("direct")
        if got is None or got[0] != PAIR_BUDGET:
            got = (PAIR_BUDGET, [self._with_direct(c) for c in chunks])
            cache["direct"] = got
        return got[1]

    def _direct_layout(self):
        """K23's layout of the pair set as one chunk (checks)."""
        (dlay,) = [c[2] for c in self._direct_chunks()]
        return dlay


class BaryonifySnapshot(DefaultRunnerSnapshot):
    """Displace particles around each halo (reference
    SnapshotRunner.py:162-275). ``process()`` returns the new particle
    catalog (a numpy structured array, positions wrapped back into the box).

    The model provides per-halo displacement curves (``halo_curves``), as a
    Baryonification2D/3D table does, or only ``displacement(r, M, a,
    **p_keys)``, read directly on every pair (see the module docstring)."""

    def process(self):
        clock = PhaseClock(self.device)
        snap = self.ParticleSnapshot
        L = snap.L
        if hasattr(self.model, "halo_curves"):
            acc = self._sharded_displace(self._curve_inputs(clock),
                                         check_mesh(self.mesh, self.device),
                                         clock)
            clock.mark("displace")
        else:
            acc = self._direct_displace(clock)
        off = acc.cpu()
        clock.mark("download")
        self.timings = clock.milliseconds()

        # the JAX runner's float64 sum and wrap (SnapshotRunner.py:351-359)
        # a column at a time, written into a copy of the catalog: torch on
        # the host, in its threads (a snapshot of 10^8 particles spends
        # seconds here)
        cols = ["x", "y"] if snap.is2D else ["x", "y", "z"]
        new_cat = np.empty_like(snap.cat)
        for name in snap.cat.dtype.names:
            if name not in cols:
                torch.from_numpy(new_cat[name]).copy_(
                    torch.from_numpy(snap.cat[name]))
        pos = torch.from_numpy(self._coords)
        for d_i, c in enumerate(cols):
            x = pos[:, d_i] + off[d_i]
            x = torch.where(x > L, x - L, x)
            torch.from_numpy(new_cat[c]).copy_(torch.where(x < 0, x + L, x))
        return new_cat

    def _sharded_displace(self, args, mesh, clock):
        """K17 on each shard's chunks (:meth:`_shard_chunks`) in turn, each
        going on from the sums of the chunks before it, into the shard's
        own offsets on its device, summed in shard order; without a mesh
        (``mesh`` None) the whole catalog is one shard, and each chunk's
        making and K17 are marked neighbours and displace on ``clock``."""
        coords, hpos, curves, ln_r0, dlnr, rscale, edge, L = args
        shards = self._shard_chunks(1 if mesh is None else len(mesh))

        def mark(name):
            if mesh is None:
                clock.mark(name)

        def work(i, idx, dev):
            acc = None
            for chunk in shards[i]:
                mark("neighbours")
                (halos, offsets, parts), layout = to_device(chunk, dev)
                acc = snapshot_displace(
                    *to_device((coords, hpos, halos, offsets, parts, curves),
                               dev), ln_r0, dlnr,
                    *to_device((rscale, edge), dev), L, layout, acc)
                mark("displace")
            return (acc,)
        acc = sharded_sum(mesh, self.device, hpos.shape[0], work)[0]
        return (torch.zeros((coords.shape[1], coords.shape[0]),
                            dtype=curves.dtype, device=self.device)
                if acc is None else acc)

    def _host_prep(self):
        """(a, M, R, R_q, halo positions, the model's p_keys columns) on
        the host, float64; raises for a snapshot of 2^31 - 1 particles or
        more (the pairs' particles are int32), as the JAX runner does."""
        cosmo = _core.cosmology_from_dict(self.cosmo)
        snap = self.ParticleSnapshot
        hcols = ["x", "y"] if snap.is2D else ["x", "y", "z"]
        cat = self.HaloNDCatalog.cat
        a = 1.0 / (1.0 + self.HaloNDCatalog.redshift)
        M = np.asarray(cat["M"], dtype=float)
        R = self.mass_def.get_radius(cosmo, M, a).numpy()
        R_q = np.clip(self.epsilon_max * R / a, 0, snap.L / 2)
        hpos = np.stack([np.asarray(cat[c], dtype=float) for c in hcols],
                        axis=1)
        pkw = {k: np.asarray(cat[k], dtype=float)
               for k in getattr(self.model, "p_keys", [])}
        n_part = len(snap.cat)
        if n_part >= np.iinfo(np.int32).max:
            raise ValueError(
                f"n_part={n_part} exceeds int32 neighbour indexing")
        return a, M, R, R_q, hpos, pkw

    def _direct_displace(self, clock):
        """The direct readout (reference SnapshotRunner.py:175-227 with
        ``model.displacement``): the host prep and the pairs' counts as the
        curve path makes them; then for each chunk, its pairs with K23's
        layout (kept with them), K23's radii pass, the model read on the
        rows of each pair's distance (its tables in float64, the values
        rounded to the runner's dtype) and K23's gather, going on from the
        chunks before. Marks host_prep, neighbours, radii, readout and
        apply; returns the (ndim, n_part) offsets."""
        require(self.model, "displacement", runner=type(self).__name__)
        dev, dt = self.device, self.dtype
        L = self.ParticleSnapshot.L
        a, M, _, R_q, hpos, pkw = self._host_prep()
        hpos_dev = torch.as_tensor(hpos, device=dev)
        clock.mark("host_prep")
        self._pair_plan(hpos, R_q)
        model = readout_model(self.model, torch.float64, dev)
        cols = {k: torch.as_tensor(v, device=dev)
                for k, v in dict(M=M, **pkw).items()}
        acc = None
        for (halos, offsets, _), layout, dlay in self._direct_chunks():
            clock.mark("neighbours")
            if self.verbose:
                print(f"[baryonforge_torch] {type(self).__name__}: "
                      f"{dlay.rows.describe()}")
            r = snapshot_radii(hpos_dev, halos, offsets, dlay, L)
            clock.mark("radii")
            hix = halos.long()
            vals = readout(
                lambda r, M, **kw: model.displacement(r, M, a, **kw), r,
                dlay.rows, {k: v[hix] for k, v in cols.items()}, dt)
            clock.mark("readout")
            acc = snapshot_direct(hpos_dev, layout[:2], dlay, vals, L, acc)
            clock.mark("apply")
        if acc is None:
            clock.mark("neighbours")
            acc = torch.zeros((hpos.shape[1], len(self._coords)), dtype=dt,
                              device=dev)
        return acc

    def _curve_inputs(self, clock):
        """The host prep, the pairs' counts and the curves (K1, in the
        runner's dtype), marked host_prep, neighbours and curves on
        ``clock``: (positions, halo positions, curves, ln_r0, dlnr, rscale,
        eps_edge, L) on the device, the arguments of ops.snapshot.
        snapshot_displace but the pairs (the model has ``halo_curves``)."""
        model = self.model
        L = self.ParticleSnapshot.L
        dev, dt = self.device, self.dtype
        npdt = np.float32 if dt == torch.float32 else np.float64
        a, M, R, R_q, hpos, pkw = self._host_prep()
        Rcom = R / a
        rscale = (1.0 / Rcom if getattr(model, "Rdelta_sampling", False)
                  else np.ones_like(Rcom))
        eps_edge = self.epsilon_max * Rcom
        hpos_dev = torch.as_tensor(hpos, device=dev)
        rscale_dev = torch.as_tensor(rscale.astype(npdt), device=dev)
        edge_dev = torch.as_tensor(eps_edge.astype(npdt), device=dev)
        clock.mark("host_prep")

        self._pair_plan(hpos, R_q)
        clock.mark("neighbours")

        curves, ln_r0, dlnr = model.with_dtype(dt, device=dev).halo_curves(
            M, np.full(M.shape, a), **pkw)
        clock.mark("curves")
        return (self._device_coords(), hpos_dev, curves.to(dt), float(ln_r0),
                float(dlnr), rscale_dev, edge_dev, L)

    def _displace_inputs(self, clock):
        """:meth:`_curve_inputs` with the pair set as one chunk
        (:meth:`_neighbour_pairs`), in the order of ops.snapshot.
        snapshot_displace's arguments (checks of K17 on the runner's own
        inputs)."""
        coords, hpos, curves, ln_r0, dlnr, rscale, edge, L = \
            self._curve_inputs(clock)
        (halos, offsets, parts), layout = self._one_chunk()
        return (coords, hpos, halos, offsets, parts, curves, ln_r0, dlnr,
                rscale, edge, L, layout)
