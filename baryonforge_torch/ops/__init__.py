"""Numerics: HEALPix geometry, the sky tiling (its per-NSIDE tables kept
for the process: geometry), integration and interpolation, FFTLog, and
the CUDA kernels' wrappers with their plain versions (curve collapse,
disc deposit, scatter regrid, tile deposit, tile paint and paint2,
stencil regrid and its complement, tile layout, FFTLog transform, table
rows, disc paint and its anisotropic form and finish, grid cutouts, grid
deposit, snapshot displacement, ring modes and Legendre transform)."""

from . import healpix
from . import integrate
from . import interp
from . import fftlog
from . import deposit
from . import regrid
from . import tiles
from . import geometry
from . import tile_deposit
from . import stencil
from . import table_rows
from . import paint
from . import grid
from . import scatter
from . import snapshot
from . import sht
