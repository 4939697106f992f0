"""Parallel front-ends and halo meshes (port of
``baryonforge_tpu.parallel``).

The reference parallelizes with joblib/loky processes + pickle
(utils/Parallelize.py); here:

  * a halo mesh (``halo_mesh``): the runners accept ``mesh=`` and split
    the halo catalog into contiguous shards, each shard's phase A (or
    paint) on its device and CUDA stream into its own accumulator, summed
    in shard order (SplitJoinParallel attaches a mesh to a copy of a
    runner);
  * SimpleParallel: independent runners (e.g. many shells) from a thread
    pool, each on its own CUDA stream.
"""

from .mesh import halo_mesh, SimpleParallel, SplitJoinParallel
