"""Numerics: HEALPix geometry and the CUDA kernels' wrappers with their
plain versions (curve collapse, disc deposit, scatter regrid)."""

from . import healpix
from . import interp
from . import deposit
from . import regrid
