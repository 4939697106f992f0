"""Support utilities: constants, IO data objects, the tabulated profiles,
the pixel windows and the spherical-harmonic analysis (``sht``).
``utils.convert`` (JAX-object conversion) needs the rest of the package
and is imported on its own."""

from . import constants
from . import sht
from .io import (HaloLightConeCatalog, HaloNDCatalog, LightconeShell,
                 GriddedMap, ParticleSnapshot)
from .Tabulate import TabulatedProfile, ParamTabulatedProfile
from .Pixel import ConvolvedProfile, HealPixel, GridPixelApprox, NoPix
