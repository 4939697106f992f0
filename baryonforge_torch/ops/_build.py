"""Build and load the port's CUDA kernels, and count their launches.

At first use, ``library()`` compiles every ``csrc/*.cu`` into one shared
library with a plain C interface (``nvcc ... -shared``) under
``baryonforge_torch/_build/``, keyed by a hash of the sources and flags,
and loads it with ``ctypes``. Nothing is built on import: the CPU tests
import every module, and only the machine with the card has ``nvcc``.

``launches`` counts, per kernel, the launches made by the wrappers in
``ops/interp.py``, ``ops/deposit.py`` and ``ops/regrid.py``; each wrapper
adds one right where it launches its kernel, so a run can show that its
main path went through the kernels.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["build", "library", "launches", "reset_launches", "check",
           "stream_of", "ptr", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

# --fmad=false keeps a*b+c as two rounded operations, as the plain
# versions (one torch op each) compute them; the kernels are bound by
# atomics, not by arithmetic
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

launches = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double

_SIGNATURES = {
    "bf_collapse_curves_f32": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _F, _P, _P],
    "bf_collapse_curves_f64": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _D, _P, _P],
    "bf_disc_deposit_f32": [_I, _I] + [_P] * 8 + [_I, _F, _F, _F, _P, _P],
    "bf_disc_deposit_f64": [_I, _I] + [_P] * 8 + [_I, _D, _D, _D, _P, _P],
    "bf_regrid_f32_f32": [_I, _P, _P, _P, _P],
    "bf_regrid_f32_f64": [_I, _P, _P, _P, _P],
    "bf_regrid_f64_f32": [_I, _P, _P, _P, _P],
    "bf_regrid_f64_f64": [_I, _P, _P, _P, _P],
}

_lib = None


def reset_launches():
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
    return the library's path. Raises with nvcc's output on failure."""
    out = _BUILD / f"libbf_kernels_{_digest()}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sorted(_CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp] + cu
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)            # atomic: a concurrent build loses nothing
    return out


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
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
    """Handle of the current PyTorch stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
