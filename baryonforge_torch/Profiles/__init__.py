"""Halo profile models: the profile framework, the Schneider19 family, the
thermodynamic profiles and the displacement model."""

from . import Base
from . import Schneider19
from .Base import Profile, hyper_params
from .Schneider19 import (SchneiderProfiles, DarkMatter, TwoHalo, Stars,
                          SatelliteStars, Gas, ShockedGas,
                          CollisionlessMatter, DarkMatterOnly,
                          DarkMatterBaryon)
from . import Thermodynamic
from . import BaryonCorrection
from .BaryonCorrection import (BaryonificationClass, Baryonification3D,
                               Baryonification2D)
