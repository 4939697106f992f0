"""Numerics: HEALPix geometry, the sky tiling, and the CUDA kernels'
wrappers with their plain versions (curve collapse, disc deposit, scatter
regrid, tile deposit, stencil regrid and its complement, tile layout)."""

from . import healpix
from . import interp
from . import deposit
from . import regrid
from . import tiles
from . import tile_deposit
from . import stencil
