"""Cosmology core in torch float64 (port of baryonforge_tpu.cosmo)."""

from .core import (Cosmology, Eofa, rho_crit, rho_x,
                   comoving_radial_distance, angular_diameter_distance,
                   cosmology_from_dict)
from .massdef import MassDef, MassDef200c, MassDef200m, MassDef500c
