"""baryonforge_torch — the PyTorch/CUDA port of baryonforge_tpu.

The JAX package ``baryonforge_tpu`` is the reference; this package ports it
slice by slice to PyTorch, with the TPU's hand-shaped device programs
rewritten as CUDA kernels for Hopper (sm_90a) under ``csrc/``, each with a
plain PyTorch version beside it. It imports torch and numpy, never jax.

Ported (ROADMAP.md lists what remains: runner behaviour, not modules):
  cosmo/      background, distances, growth, linear power, sigma(M),
              xi(r), mass definitions, concentrations (float64)
  ops/        HEALPix geometry and the sky tiling (its per-NSIDE tables
              kept for the process: ``clear_geometry_cache()`` frees them);
              integration and interpolation; kernels K1 curve collapse
              (interp), K2 disc deposit (deposit), K3 scatter regrid
              (regrid), K4 tile deposit, K10 tile paint and K12 paint2
              (tile_deposit), K5 stencil regrid and K6 its complement
              (stencil), K7 tile layout (tiles), K8 FFTLog transform
              (fftlog), K9 table rows (table_rows), K11 disc paint, K13 its
              anisotropic form and K14 the anisotropic finish (paint), K15
              grid cutouts (grid), K16 grid deposit (scatter), K17 snapshot
              displacement (snapshot), K18 ring modes and K19 Legendre
              transform (sht)
  native/     the snapshot runner's periodic cell list (host C++, g++)
  Profiles/   the profile framework and algebra, the Schneider19,
              Arico20, Mead20 (with its T_AGN calibrations) and Schneider25
              families, the Battaglia12 pressure and density, the utility
              profiles (truncation, test doubles, per-halo Fourier
              limits, unit wrappers), the thermodynamic (tSZ) profiles,
              Baryonification2D/3D: table build, readout and checkpoint
  Runners/    BaryonifyShell: the tiled engine (default) and the scatter
              path; PaintProfilesShell and PaintProfilesAnisShell: the
              tiled paint (default) and the disc paint; the grid runners
              BaryonifyGrid, PaintProfilesGrid and PaintProfilesAnisGrid;
              the particle snapshot runner BaryonifySnapshot; each takes a
              halo ``mesh`` (shards summed in order)
  utils/      constants, io containers and FITS shells (fitsio), tabulated
              profiles and TabulatedCorrelation3D, pixel windows, profile
              memoization (Cache), spherical-harmonic analysis (sht), the
              halo model (halomodel), JAX-object conversion (convert), the
              root finder, FFTLog merge rules and timing helpers (misc,
              debug), the S19 validation pipelines (validation: ``python
              -m baryonforge_torch.utils.validation --out FILE`` writes the
              port's rows in PARITY.json's layout)
  parallel/   halo_mesh, SimpleParallel (runners from threads, a CUDA
              stream each) and SplitJoinParallel (a runner with a mesh)

Every module of the JAX package has its counterpart here.
"""

from . import cosmo
from . import ops
from . import utils
from . import Profiles
from . import Runners
from . import parallel
from .ops.geometry import clear_geometry_cache
from .utils.io import (HaloLightConeCatalog, HaloNDCatalog, LightconeShell,
                       GriddedMap, ParticleSnapshot)
from .Profiles import *       # noqa: F401,F403
from .Runners import *        # noqa: F401,F403

__version__ = "0.1.0"
