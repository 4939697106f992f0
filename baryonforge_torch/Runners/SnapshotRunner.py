"""Particle snapshot runner: BaryonifySnapshot (2D and 3D periodic boxes).

Port of ``baryonforge_tpu.Runners.SnapshotRunner`` (reference
SnapshotRunner.py:162-275):

  host prep   per-halo R_Delta(M, a) at the snapshot's redshift, the query
              radii R_q = clip(eps R / a, 0, L / 2), the lookup's radius
              scale and the cut eps Rcom (numpy float64)
  neighbours  the (halo, particle) pairs within R_q, grouped per halo: the
              port's periodic cell list in 3D (``native``), scipy's cKDTree
              in 2D; and their particle-major layout, K17's input
              (ops/snapshot.particle_layout, a sort on the device); both
              cached on the device, keyed by the catalog's content and the
              radii
  K1          per-halo displacement curves at the single redshift
              (ops/interp.collapse_curves), in the runner's dtype
  K17         every pair's displacement summed per particle
              (ops/snapshot.snapshot_displace)

then the host adds the offsets to the positions in float64 and wraps them
into [0, L]. A model without ``halo_curves`` takes the direct readout, as
the JAX body does: K23's radii pass (ops/snapshot.snapshot_radii) writes
each pair's distance into its halo's row (rows grouped by their pair
counts, ops/direct.row_layout), the model's ``displacement`` is read on
them under ``torch.func.vmap`` (ops/direct.readout, its tables in float64)
and K23's gather (ops/snapshot.snapshot_direct) sums the values per
particle; it runs the whole catalog on the runner's device, with or
without a mesh. K23's layout (the rows, each row's slots and pieces, each
particle-major entry's (slot, halo) record, the positions in K17's
particle order: ops/snapshot.direct_layout) is cached with the pairs, so
a call reads nothing back to the host between the pair cache and its
result. The JAX runner pads count buckets of halos to static shapes
and scans them in batches (``n_size_buckets``, ``halo_batch``); here the
pairs are exact lists and one launch covers them all.

With a ``mesh`` (``parallel.halo_mesh``) the halos split into contiguous
shards: each shard's rows of the pairs, with their own particle-major
layout (cached with the pairs), go through K17 into their own offsets on
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
from ..ops.snapshot import (direct_layout, particle_layout, snapshot_direct,
                            snapshot_displace, snapshot_radii)
from ..ops.tiles import pairs_csr
from ..parallel.mesh import check_mesh, sharded_sum, to_device
from .HealpixRunner import _PhaseClock

__all__ = ["DefaultRunnerSnapshot", "BaryonifySnapshot"]


class DefaultRunnerSnapshot:
    """Shared state for snapshot runners (reference SnapshotRunner.py).

    ``dtype`` is the curves' and the offsets' dtype (float32 by default);
    positions and distances are float64, as the JAX runner computes them
    under x64. ``device`` is where the kernels run: "cuda" by default, and it
    raises when CUDA is absent; the CPU runs the plain versions and must be
    asked for explicitly. ``KDTree_kwargs`` go to the 2D cKDTree.

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
        self._coords_dev = None
        # (key, device CSR, K17's layout, {n_shards: the shards' rows,
        # "direct": K23's layout})
        self._pairs = None
        # milliseconds of each phase of the last process() call (see
        # _PhaseClock): host_prep, neighbours, curves, displace, download;
        # radii, readout and apply instead of curves and displace for the
        # direct readout
        self.timings = {}

    @property
    def tree(self):
        """Lazy scipy cKDTree of the particles (the 2D neighbour search;
        scipy.spatial is imported here, so that importing the package does
        not load it)."""
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

    def _neighbour_pairs(self, hpos, R_q):
        """The (halo, particle) pairs within R_q on the device: (the
        halo-major CSR (halos, offsets, parts) int32, as ops.tiles.pairs_csr
        groups them, halos without particles having no row; its
        particle-major layout (order, poff, prow), as
        ops.snapshot.particle_layout builds it), built once per catalog
        content and radii (a parameter sweep reuses them)."""
        key = (self._catalog_token(),
               hashlib.blake2b(np.ascontiguousarray(R_q).tobytes(),
                               digest_size=16).hexdigest())
        if self._pairs is not None and self._pairs[0] == key:
            return self._pairs[1:3]
        L = self.ParticleSnapshot.L
        if self.ParticleSnapshot.is2D:
            lists = self.tree.query_ball_point(np.mod(hpos, L), R_q)
            counts = np.array([len(x) for x in lists], dtype=np.int64)
            idx = (np.concatenate([np.asarray(x, dtype=np.int32)
                                   for x in lists])
                   if counts.sum() else np.zeros(0, dtype=np.int32))
        else:
            counts, idx = cell_query(self._coords, L, hpos, R_q)
        if counts.sum() >= np.iinfo(np.int32).max:
            raise ValueError(f"{int(counts.sum())} neighbour pairs exceed "
                             "int32 offsets")
        halo_of = np.repeat(np.arange(counts.size, dtype=np.int32), counts)
        csr = tuple(torch.as_tensor(x, device=self.device)
                    for x in pairs_csr(halo_of, idx))
        if self._coords_dev is None:
            self._coords_dev = torch.as_tensor(self._coords,
                                               device=self.device)
        layout = particle_layout(self._coords_dev, L, *csr[1:])
        self._pairs = (key, csr, layout, {})
        return csr, layout

    def _direct_layout(self):
        """K23's layout of the cached pairs (ops.snapshot.direct_layout),
        built at the first direct call on a pair set and kept with it."""
        cache = self._pairs[3]
        if "direct" not in cache:
            (halos, offsets, parts), layout = self._pairs[1:3]
            cache["direct"] = direct_layout(self._coords_dev, halos,
                                            offsets, parts, layout[0])
        return cache["direct"]

    def _shard_pairs(self, n_halos, n_shards):
        """Each shard's rows of the cached pairs (the halos np.array_split
        into ``n_shards``): (halos, offsets from 0, parts) and their
        particle-major layout on the runner's device, or None for a shard
        without pairs; made once per pair set and shard count. One shard
        is the cached pairs and layout themselves."""
        csr, shards = self._pairs[1], self._pairs[3]
        if n_shards == 1:
            return [(csr, self._pairs[2])]
        if n_shards not in shards:
            halos, offsets, parts = csr
            h = halos.cpu().numpy()
            off = offsets.cpu().numpy()
            out = []
            for idx in np.array_split(np.arange(n_halos), n_shards):
                r0, r1 = (np.searchsorted(h, [idx[0], idx[-1] + 1])
                          if idx.size else (0, 0))
                if r1 == r0:
                    out.append(None)
                    continue
                o = offsets[r0:r1 + 1] - offsets[r0]
                p = parts[int(off[r0]):int(off[r1])]
                out.append(((halos[r0:r1], o, p), particle_layout(
                    self._coords_dev, self.ParticleSnapshot.L, o, p)))
            shards[n_shards] = out
        return shards[n_shards]


class BaryonifySnapshot(DefaultRunnerSnapshot):
    """Displace particles around each halo (reference
    SnapshotRunner.py:162-275). ``process()`` returns the new particle
    catalog (a numpy structured array, positions wrapped back into the box).

    The model provides per-halo displacement curves (``halo_curves``), as a
    Baryonification2D/3D table does, or only ``displacement(r, M, a,
    **p_keys)``, read directly on every pair (see the module docstring)."""

    def process(self):
        clock = _PhaseClock(self.device)
        snap = self.ParticleSnapshot
        L = snap.L
        if hasattr(self.model, "halo_curves"):
            args = self._displace_inputs(clock)
            acc = self._sharded_displace(args,
                                         check_mesh(self.mesh, self.device))
            clock.mark("displace")
        else:
            acc = self._direct_displace(clock)
        off = acc.cpu().numpy()
        clock.mark("download")
        self.timings = clock.milliseconds()

        # the JAX runner's float64 sum and wrap (SnapshotRunner.py:351-359),
        # in place on the contiguous copy of the positions, then one write
        # a column
        pos = self._coords + off.T
        np.subtract(pos, L, out=pos, where=pos > L)
        np.add(pos, L, out=pos, where=pos < 0)
        new_cat = snap.cat.copy()
        for d_i, c in enumerate(["x", "y"] if snap.is2D else ["x", "y", "z"]):
            new_cat[c] = pos[:, d_i]
        return new_cat

    def _sharded_displace(self, args, mesh):
        """K17 on each shard's rows (:meth:`_shard_pairs`), into its own
        offsets on its device, summed in shard order; without a mesh
        (``mesh`` None), on every pair at once."""
        (coords, hpos, _, _, _, curves, ln_r0, dlnr, rscale, edge, L,
         _) = args
        shards = self._shard_pairs(hpos.shape[0],
                                   1 if mesh is None else len(mesh))

        def work(i, idx, dev):
            if shards[i] is None:
                return (None,)
            (halos, offsets, parts), layout = to_device(shards[i], dev)
            return (snapshot_displace(
                *to_device((coords, hpos, halos, offsets, parts, curves),
                           dev), ln_r0, dlnr,
                *to_device((rscale, edge), dev), L, layout),)
        acc = sharded_sum(mesh, self.device, hpos.shape[0], work)[0]
        return (torch.zeros((coords.shape[1], coords.shape[0]),
                            dtype=curves.dtype, device=self.device)
                if acc is None else acc)

    def _host_prep(self):
        """(a, M, R, R_q, halo positions, the model's p_keys columns) on
        the host, float64; raises for a snapshot of 2^31 - 1 particles or
        more."""
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
        ``model.displacement``): the host prep and the pairs as the curve
        path makes them with K23's layout (cached with them), K23's radii
        pass, the model read on the rows of each pair's distance (its
        tables in float64, the values rounded to the runner's dtype), K23's
        gather. Marks host_prep, neighbours, radii, readout and apply;
        returns the (ndim, n_part) offsets."""
        require(self.model, "displacement", runner=type(self).__name__)
        dev, dt = self.device, self.dtype
        L = self.ParticleSnapshot.L
        a, M, _, R_q, hpos, pkw = self._host_prep()
        hpos_dev = torch.as_tensor(hpos, device=dev)
        clock.mark("host_prep")
        (halos, offsets, _), layout = self._neighbour_pairs(hpos, R_q)
        dlay = self._direct_layout()
        clock.mark("neighbours")
        if self.verbose:
            print(f"[baryonforge_torch] {type(self).__name__}: "
                  f"{dlay.rows.describe()}")
        r = snapshot_radii(hpos_dev, halos, offsets, dlay, L)
        clock.mark("radii")
        model = readout_model(self.model, torch.float64, dev)
        hix = halos.long()
        cols = {k: torch.as_tensor(v, device=dev)[hix]
                for k, v in dict(M=M, **pkw).items()}
        vals = readout(lambda r, M, **kw: model.displacement(r, M, a, **kw),
                       r, dlay.rows, cols, dt)
        clock.mark("readout")
        acc = snapshot_direct(hpos_dev, layout[:2], dlay, vals, L)
        clock.mark("apply")
        return acc

    def _displace_inputs(self, clock):
        """The host prep, the neighbour pairs with their particle-major
        layout and the curves (K1, in the runner's dtype), marked
        host_prep, neighbours and curves on ``clock``: the arguments of
        ops.snapshot.snapshot_displace (the model has ``halo_curves``)."""
        model = self.model
        snap = self.ParticleSnapshot
        L = snap.L
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

        (halos, offsets, parts), layout = self._neighbour_pairs(hpos, R_q)
        clock.mark("neighbours")

        curves, ln_r0, dlnr = model.with_dtype(dt, device=dev).halo_curves(
            M, np.full(M.shape, a), **pkw)
        clock.mark("curves")
        return (self._coords_dev, hpos_dev, halos, offsets, parts,
                curves.to(dt), float(ln_r0), float(dlnr), rscale_dev,
                edge_dev, L, layout)
