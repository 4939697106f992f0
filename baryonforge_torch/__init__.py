"""baryonforge_torch — the PyTorch/CUDA port of baryonforge_tpu.

The JAX package ``baryonforge_tpu`` is the reference; this package ports it
slice by slice to PyTorch, with the TPU's hand-shaped device programs
rewritten as CUDA kernels for Hopper (sm_90a) under ``csrc/``, each with a
plain PyTorch version beside it. It imports torch and numpy, never jax.

Ported so far (ROADMAP.md lists the rest):
  cosmo/      background, distances, growth, linear power, sigma(M),
              xi(r), mass definitions, concentrations (float64)
  ops/        HEALPix geometry and the sky tiling; integration and
              interpolation; kernels K1 curve collapse (interp), K2 disc
              deposit (deposit), K3 scatter regrid (regrid), K4 tile
              deposit, K10 tile paint and K12 paint2 (tile_deposit), K5
              stencil regrid and K6 its complement (stencil), K7 tile
              layout (tiles), K8 FFTLog transform (fftlog), K9 table rows
              (table_rows), K11 disc paint, K13 its anisotropic form and
              K14 the anisotropic finish (paint), K15 grid cutouts (grid),
              K16 grid deposit (scatter), K17 snapshot displacement
              (snapshot), K18 ring modes and K19 Legendre transform (sht)
  native/     the snapshot runner's periodic cell list (host C++, g++)
  Profiles/   the profile framework and algebra, the Schneider19 family,
              the thermodynamic (tSZ) profiles, Baryonification2D/3D:
              table build, readout and checkpoint
  Runners/    BaryonifyShell: the tiled engine (default) and the scatter
              path; PaintProfilesShell and PaintProfilesAnisShell: the
              tiled paint (default) and the disc paint; the grid runners
              BaryonifyGrid, PaintProfilesGrid and PaintProfilesAnisGrid;
              the particle snapshot runner BaryonifySnapshot
  utils/      constants, io containers, tabulated profiles, pixel windows,
              spherical-harmonic analysis (sht), JAX-object conversion
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
