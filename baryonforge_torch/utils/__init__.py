"""Support utilities: constants, IO data objects, the tabulated profiles
and the tabulated correlation function, the pixel windows, profile
memoization (``Cache``), FITS I/O, the halo model (``halomodel``), the
timing helpers (``debug``), the parallel front-ends and the
spherical-harmonic analysis (``sht``). ``utils.convert`` (JAX-object
conversion) and ``utils.validation`` (the S19 pipelines) need the rest of
the package and are imported on their own."""

from . import constants
from . import sht
from .io import (HaloLightConeCatalog, HaloNDCatalog, LightconeShell,
                 GriddedMap, ParticleSnapshot)
from .Tabulate import (_set_parameter, _get_parameter, TabulatedProfile,
                       ParamTabulatedProfile, TabulatedCorrelation3D)
from .Pixel import ConvolvedProfile, GridPixelApprox, HealPixel, NoPix
from .Cache import SimpleArrayCache, CachedProfile, CachedHODProfile
from .misc import (safe_Pchip_minimize, destory_Pk, destroy_Pk,
                   combine_fftpars, log_time)
from . import debug
from .fitsio import read_healpix_fits, write_healpix_fits
from .Parallelize import SimpleParallel, SplitJoinParallel
from . import halomodel
from .halomodel import FlexibleHMCalculator
