"""Support utilities: constants, IO data objects, the tabulated profiles
and the pixel windows. ``utils.convert`` (JAX-object conversion) needs the
rest of the package and is imported on its own."""

from . import constants
from .io import (HaloLightConeCatalog, HaloNDCatalog, LightconeShell,
                 GriddedMap, ParticleSnapshot)
from .Tabulate import TabulatedProfile, ParamTabulatedProfile
from .Pixel import ConvolvedProfile, HealPixel, GridPixelApprox, NoPix
