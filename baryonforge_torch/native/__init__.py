"""Host C++: the periodic cell-list neighbour search of BaryonifySnapshot.

``cell_list.cpp`` is the port's counterpart of the JAX package's cell list
(``baryonforge_tpu/native/kernels.cpp:87-164``): the same neighbour sets,
but each cell is visited once when a search window wraps onto itself
(there rmax > L / 3), where the JAX copy counts particles twice or more;
and cells sized by the median radius, particles stored cell by cell and
the queries split over threads. At first use it is compiled with ``g++ -O3
-shared -fPIC`` into ``baryonforge_torch/_build/``, keyed by a hash of the
source, and loaded with ``ctypes``. There is no fallback: without g++, or
when the build fails, ``cell_query`` raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["cell_query", "library"]

_SRC = Path(__file__).resolve().parent / "cell_list.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
# threads of a query: the queries are split in contiguous ranges
_THREADS = max(1, min(8, os.cpu_count() or 1))

_lib = None


def _build():
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the snapshot runner's "
                           "cell list cannot be built")
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    out = _BUILD / f"libbf_cell_list_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as work:
        tmp = os.path.join(work, "lib.so")
        res = subprocess.run([gxx] + _FLAGS + ["-o", tmp, str(_SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)        # atomic: a concurrent build loses nothing
    return out


def library():
    """The loaded cell-list library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        p, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
        lib.bf_cell_query.argtypes = [p, i64, f64, p, p, i64, f64,
                                      ctypes.c_int, p]
        lib.bf_cell_query.restype = p
        lib.bf_cell_query_fetch.argtypes = [p, p]
        lib.bf_cell_query_fetch.restype = None
        lib.bf_cell_query_free.argtypes = [p]
        lib.bf_cell_query_free.restype = None
        _lib = lib
    return _lib


def cell_query(positions, L, centers, radii):
    """Periodic fixed-radius neighbour search in 3D.

    positions : (n, 3) particle positions; centers : (nq, 3); radii : (nq,)
    (both taken mod L). A particle is a neighbour of query q when its
    minimum-image distance to centers[q] is at most radii[q].

    Returns (counts (nq,) int64, indices (counts.sum(),) int32): the
    neighbours of query 0, then of query 1, ..., in cell order.
    """
    lib = library()
    positions = np.ascontiguousarray(np.mod(positions, L), dtype=np.float64)
    centers = np.ascontiguousarray(np.mod(centers, L), dtype=np.float64)
    radii = np.ascontiguousarray(radii, dtype=np.float64)
    nq = radii.size
    counts = np.zeros(nq, dtype=np.int64)
    if nq == 0:
        return counts, np.zeros(0, dtype=np.int32)
    # cells of about the median radius: each query walks the cells its own
    # radius reaches
    pos_r = radii[radii > 0]
    size = float(np.median(pos_r)) if pos_r.size else float(L)
    handle = lib.bf_cell_query(positions.ctypes.data, len(positions),
                               float(L), centers.ctypes.data,
                               radii.ctypes.data, nq, size,
                               _THREADS if nq >= 256 else 1,
                               counts.ctypes.data)
    try:
        idx = np.empty(int(counts.sum()), dtype=np.int32)
        lib.bf_cell_query_fetch(handle, idx.ctypes.data)
    finally:
        lib.bf_cell_query_free(handle)
    return counts, idx
