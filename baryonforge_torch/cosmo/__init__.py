"""Cosmology in torch float64 (port of baryonforge_tpu.cosmo): background,
distances, growth, linear power, mass definitions, concentrations."""

from .core import (Cosmology, Eofa, hubble_Ha, rho_crit, rho_x,
                   comoving_radial_distance, angular_diameter_distance,
                   growth_factor, cosmology_from_dict, build_cosmodict)
from .power import (linear_power, sigmaR, sigmaM, correlation_3d,
                    lagrangian_radius, pk_grid, dlnP_dlnk,
                    transfer_eh98, transfer_eh98_nowiggle, transfer_bbks)
from .massdef import (MassDef, MassDef200c, MassDef200m, MassDef500c,
                      nfw_mu, translate_mass)
from .concentration import (ConcentrationConstant, ConcentrationDiemer15,
                            ConcentrationDuffy08, ConcentrationBhattacharya13,
                            ConcentrationPrada12, ConcentrationKlypin11,
                            ConcentrationIshiyama21, GenericConcentration)
from .concentration import (Duffy08, Klypin11, Prada12, Diemer15,
                            Bhattacharya13, Ishiyama21)
