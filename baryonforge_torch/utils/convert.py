"""Carry JAX-package objects across to the port, without importing jax.

The JAX package's displacement model and cosmology keep their state in
numpy arrays and plain floats, so they convert by reading attributes:
``baryonification_from_jax(model)`` gives the port's model with the same
table, ``cosmology_from_jax(cosmo)`` the port's Cosmology.
"""

import dataclasses

from ..cosmo.core import Cosmology
from ..cosmo.massdef import MassDef
from ..Profiles.BaryonCorrection import Baryonification2D, Baryonification3D

__all__ = ["cosmology_from_jax", "baryonification_from_jax"]


def cosmology_from_jax(cosmo):
    """The port's Cosmology with the fields of a JAX-package Cosmology."""
    return Cosmology(**{f.name: float(getattr(cosmo, f.name))
                        for f in dataclasses.fields(Cosmology)})


def baryonification_from_jax(model):
    """The port's Baryonification2D/3D holding the table of a JAX-package
    model with a built or loaded table (its profiles are not carried)."""
    cls = Baryonification2D if model._projected else Baryonification3D
    new = cls(None, None, cosmology_from_jax(model.cosmo),
              epsilon_max=model.epsilon_max,
              mass_def=MassDef(model.mass_def.Delta, model.mass_def.rho_type))
    p_keys = [str(k) for k in model.p_keys]
    return new._set_table(
        model.raw_input_d, model.raw_input_z_range, model.raw_input_M_range,
        model.raw_input_r_range, p_keys,
        [getattr(model, f"raw_input_{k}_range") for k in p_keys],
        model.Rdelta_sampling)
