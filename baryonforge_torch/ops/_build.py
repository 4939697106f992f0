"""Build and load the port's CUDA kernels, and count their launches.

At first use, ``library()`` compiles every ``csrc/*.cu`` (one ``nvcc`` per
source, all started together) and links them into one shared library with
a plain C interface under ``baryonforge_torch/_build/``, keyed by a hash of
the sources and flags, and loads it with ``ctypes``. Nothing is built on
import: the CPU tests import every module, and only the machine with the
card has ``nvcc``.

``launches`` counts, per kernel entry point, the launches made by the
wrappers in ``ops/interp.py`` (K1), ``ops/deposit.py`` (K2),
``ops/regrid.py`` (K3), ``ops/tile_deposit.py`` (K4 ``tile_deposit``,
K10 ``tile_paint``, K12 ``tile_paint2``), ``ops/stencil.py`` (K5
``stencil_hot`` and ``stencil``, K6 ``stencil_geo`` and
``stencil_complement``), ``ops/tiles.py`` (K7 ``flat_view`` and
``tile_view``), ``ops/fftlog.py`` (K8 ``fht``), ``ops/table_rows.py`` (K9
``table_rows``, and its halves ``enclosed_mass`` and
``displacement_rows``), ``ops/paint.py`` (K11
``disc_paint``, K13 ``disc_paint_anis``, K14 ``anis_finish``, and the
check kernel ``pixel_angles``),
``ops/grid.py`` (K15 ``grid_cutout`` and its lists' ``tile_pairs``),
``ops/scatter.py`` (K16
``grid_deposit``), ``ops/snapshot.py`` (K17 ``snapshot_displace``),
``ops/sht.py`` (K18 ``ring_modes``, K19 ``legendre_alm``) and, for the
direct readout of models without ``halo_curves``, ``ops/deposit.py`` (K20
``disc_radii``), ``ops/paint.py`` (K21 ``disc_apply``), ``ops/grid.py``
(K22 ``grid_radii`` and ``grid_direct``) and ``ops/snapshot.py`` (K23
``snapshot_radii`` and ``snapshot_direct``); each wrapper
adds one right where it launches its kernel (``count``, under a lock: the
runners of ``parallel.SimpleParallel`` launch from several threads), so a
run can show that its main path went through the kernels.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["build", "library", "launches", "count", "reset_launches",
           "check",
           "stream_of", "ptr", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

# --fmad=false keeps a*b+c as two rounded operations, as the plain
# versions (one torch op each) compute them; no kernel here is bound by
# its multiply-adds
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

launches = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_LL = ctypes.c_longlong


def _signatures():
    """ctypes argument types of every C entry point, by name."""
    sig = {
        "bf_collapse_curves_f32": [_P, _P, _P, _I, _F, _P, _P],
        "bf_collapse_curves_f64": [_P, _P, _P, _I, _D, _P, _P],
        "bf_disc_deposit_f32": [_I, _I] + [_P] * 8 + [_I, _F, _F, _F, _P, _P],
        "bf_disc_deposit_f64": [_I, _I] + [_P] * 8 + [_I, _D, _D, _D, _P, _P],
        "bf_tile_deposit_f32": [_I] * 5 + [_P] * 14 + [_I, _F, _F, _P, _P],
        "bf_tile_deposit_f64": [_I] * 5 + [_P] * 14 + [_I, _D, _D, _P, _P],
        "bf_tile_paint_f32": [_I] * 5 + [_P] * 13 + [_I, _F, _F, _I, _P, _P],
        "bf_tile_paint_f64": [_I] * 5 + [_P] * 13 + [_I, _D, _D, _I, _P, _P],
        "bf_tile_paint2_f32": [_I] * 5 + [_P] * 14
        + [_I, _F, _F, _I, _F, _F, _I, _P, _P],
        "bf_tile_paint2_f64": [_I] * 5 + [_P] * 14
        + [_I, _D, _D, _I, _D, _D, _I, _P, _P],
        "bf_fht_f64": [_I] * 5 + [_P, _P, _D, _D, _D, _P, _P, _P, _P],
        "bf_fht_long_blocks": [],
        "bf_table_rows_f64": [_I, _I, _I] + [_P] * 8,
        "bf_enclosed_mass_f64": [_I, _I, _I] + [_P] * 6,
        "bf_displacement_rows_f64": [_I, _I] + [_P] * 5,
        "bf_ring_modes_f64": [_I] + [_P] * 5 + [_I] + [_P] * 5,
        "bf_ring_modes_long_blocks": [],
        "bf_shared_memory_optin": [_I],
        "bf_legendre_alm_f64": [_I, _I, _I] + [_P] * 8,
        "bf_legendre_chains_per_block": [],
        "bf_stencil_smem_bytes": [_I] * 5,
        "bf_tile_pairs": [_I] * 7 + [_P, _P, _D, _P, _I, _P, _P, _P],
        "bf_snapshot_record_bytes": [_I],
        "bf_grid_deposit_tile": [_I, _I],
        "bf_regrid_scratch_bytes": [_I, _I, _P],
        "bf_disc_apply_anis": [_LL] + [_P] * 7 + [_I, _D, _P, _P],
        "bf_grid_radii": [_I] * 3 + [_P, _D] + [_P] * 3,
        "bf_disc_layout": [_I] + [_P] * 5,
        "bf_snapshot_radii": [_I, _I, _I, _D] + [_P] * 9,
    }
    for sfx in ("f32", "f64"):
        sig[f"bf_flat_view_{sfx}"] = [_I] * 4 + [_P] * 3 + [_I] + [_P] * 3
        sig[f"bf_tile_view_{sfx}"] = sig[f"bf_flat_view_{sfx}"]
        sig[f"bf_stencil_hot_{sfx}"] = [_I, _I] + [_P] * 6
        sig[f"bf_stencil_geo_{sfx}"] = [_I] * 4 + [_P] * 9
        flt = _F if sfx == "f32" else _D
        for rsfx in ("f32", "f64"):
            # offsets in the first dtype, maps in the second
            sig[f"bf_regrid_{sfx}_{rsfx}"] = [_I] + [_P] * 5
            sig[f"bf_stencil_{sfx}_{rsfx}"] = [_I] * 6 + [_P] * 14
            sig[f"bf_stencil_complement_{sfx}_{rsfx}"] = \
                [_I] * 4 + [_P] * 3 + [_I] + [_P] * 8
            # curves in the first dtype, the painted map in the second
            sig[f"bf_disc_paint_{sfx}_{rsfx}"] = \
                [_I, _I] + [_P] * 6 + [_I, flt, flt, _I, _I, _D, _P, _P]
            # offsets in the first dtype, maps in the second
            sig[f"bf_grid_deposit_{sfx}_{rsfx}"] = [_I, _I] + [_P] * 4
        curve = [_P, _I, _D, _D, _I]
        sig[f"bf_disc_paint_anis_{sfx}"] = \
            [_I, _I] + [_P] * 5 + curve + curve + [_P, _P, _I, _D, _P, _P]
        sig[f"bf_anis_finish_{sfx}"] = [_LL] + [_P] * 3 + [_D] * 3 \
            + [_I, _P, _P]
        sig[f"bf_pixel_angles_{sfx}"] = [_I, _I, _P, _P, _P]
        sig[f"bf_grid_cutout_{sfx}"] = [_I] * 5 + [_P] * 4 + [_D] + [_P] * 3 \
            + curve + curve + [_D] + [_P] * 4
        sig[f"bf_snapshot_displace_{sfx}"] = [_I, _I, _D] + [_P] * 7 \
            + [_I, _D, _D, _P, _P]
        sig[f"bf_disc_radii_{sfx}"] = [_I] * 3 + [_P] * 5 + [_I] + [_P] * 8
        sig[f"bf_disc_apply_displace_{sfx}"] = [_LL] + [_P] * 7
        for rsfx in ("f32", "f64"):
            # values in the first dtype, the painted map in the second
            sig[f"bf_disc_apply_paint_{sfx}_{rsfx}"] = \
                [_LL] + [_P] * 4 + [_I, _D] + [_P] * 2
        sig[f"bf_grid_direct_{sfx}"] = [_I] * 5 + [_P] * 6 + [_D] + [_P] * 8
        sig[f"bf_snapshot_direct_{sfx}"] = [_I, _I, _D] + [_P] * 8
    return sig


_SIGNATURES = _signatures()

_lib = None
_lock = threading.Lock()
_build_lock = threading.Lock()


def count(name):
    """Add one launch of entry point ``name`` to ``launches``."""
    with _lock:
        launches[name] += 1


def reset_launches():
    with _lock:
        launches.clear()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels (if this source hash has no library yet) and
    return the library's path: one nvcc per source, all started together,
    then one link. Raises with nvcc's output on failure."""
    out = _BUILD / f"libbf_kernels_{_digest()}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=_BUILD) as work:
        jobs = []
        for src in sorted(_CSRC.glob("*.cu")):
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc] + compile_flags + ["-c", str(src), "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            so, se = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{so}\n{se}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp] + [o for _, o, _ in jobs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)        # atomic: a concurrent build loses nothing
    return out


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err, name):
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_of(t):
    """Handle of the current PyTorch stream on ``t``'s device (the raw
    handle, without building a torch.cuda.Stream: a few microseconds less
    of host time a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
