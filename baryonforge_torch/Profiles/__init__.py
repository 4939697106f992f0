"""Displacement model (table half; the profile families are not ported
yet)."""

from . import BaryonCorrection
from .BaryonCorrection import (BaryonificationClass, Baryonification3D,
                               Baryonification2D)
