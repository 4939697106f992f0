"""baryonforge_torch — the PyTorch/CUDA port of baryonforge_tpu.

The JAX package ``baryonforge_tpu`` is the reference; this package ports it
slice by slice to PyTorch, with the TPU's hand-shaped device programs
rewritten as CUDA kernels for Hopper (sm_90a) under ``csrc/``, each with a
plain PyTorch version beside it. It imports torch and numpy, never jax.

Ported so far (ROADMAP.md lists the rest):
  cosmo/      background, distances, mass definitions (float64)
  ops/        HEALPix geometry; kernels K1 curve collapse (interp),
              K2 disc deposit (deposit), K3 scatter regrid (regrid)
  Profiles/   Baryonification2D/3D table readout and checkpoint
  Runners/    BaryonifyShell, scatter path
  utils/      constants, io containers, JAX-object conversion
"""

from . import cosmo
from . import ops
from . import utils
from . import Profiles
from . import Runners
from .utils.io import (HaloLightConeCatalog, HaloNDCatalog, LightconeShell,
                       GriddedMap, ParticleSnapshot)
from .Profiles import *       # noqa: F401,F403
from .Runners import *        # noqa: F401,F403

__version__ = "0.1.0"
