"""API-parity alias: the reference exposes SimpleParallel/SplitJoinParallel
under utils.Parallelize; the implementations live in parallel/mesh.py
(CUDA streams and shards of the halo catalog replace joblib processes)."""

from ..parallel.mesh import SimpleParallel, SplitJoinParallel, halo_mesh

__all__ = ["SimpleParallel", "SplitJoinParallel", "halo_mesh"]
