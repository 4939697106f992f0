"""Support utilities: constants and IO data objects. ``utils.convert``
(JAX-object conversion) needs the rest of the package and is imported
on its own."""

from . import constants
from .io import (HaloLightConeCatalog, HaloNDCatalog, LightconeShell,
                 GriddedMap, ParticleSnapshot)
