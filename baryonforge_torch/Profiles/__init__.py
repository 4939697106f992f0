"""Halo profile models: the profile framework, the Schneider19, Arico20,
Mead20 and Schneider25 families, the Battaglia12 calibrations, the utility
profiles, the thermodynamic profiles and the displacement model."""

from . import Base
from . import misc
from . import Schneider19

from .Base import Profile, hyper_params
from .misc import Truncation, Identity, Zeros, TruncatedFourier, \
    ComovingToPhysical, Mdelta_to_Mtot
from .Schneider19 import (SchneiderProfiles, DarkMatter, TwoHalo, Stars,
                          SatelliteStars, Gas, ShockedGas,
                          CollisionlessMatter, DarkMatterOnly,
                          DarkMatterBaryon)
from . import Arico20
from . import Mead20
from . import Schneider25
from . import Battaglia
from . import Thermodynamic
from . import BaryonCorrection
from .BaryonCorrection import (BaryonificationClass, Baryonification3D,
                               Baryonification2D)
