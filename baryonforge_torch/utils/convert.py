"""Carry JAX-package objects across to the port, without importing jax.

The JAX package keeps its state in numpy arrays, plain numbers and small
Python objects, so they convert by reading attributes:

  * ``cosmology_from_jax(cosmo)``: the port's Cosmology;
  * ``profile_from_jax(prof)``: the port's counterpart of a Schneider19
    profile, with its nested sub-profiles and combined (algebra) profiles,
    model and hyper parameters, FFTLog precision, mass definition and
    concentration relation;
  * ``baryonification_from_jax(model)``: the port's displacement model,
    with its table when it has one and its DMO/DMB profiles when it has
    them.
"""

import dataclasses

import numpy as np

from ..cosmo import concentration as _conc
from ..cosmo.core import Cosmology
from ..cosmo.massdef import MassDef
from ..Profiles import Base as _base
from ..Profiles import Schneider19 as _s19
from ..Profiles.BaryonCorrection import Baryonification2D, Baryonification3D

__all__ = ["cosmology_from_jax", "profile_from_jax",
           "baryonification_from_jax"]


def cosmology_from_jax(cosmo):
    """The port's Cosmology with the fields of a JAX-package Cosmology."""
    return Cosmology(**{f.name: float(getattr(cosmo, f.name))
                        for f in dataclasses.fields(Cosmology)})


def _port_class(obj, module, what):
    name = type(obj).__name__ if not isinstance(obj, type) else obj.__name__
    cls = getattr(module, name, None)
    if not isinstance(cls, type):
        raise NotImplementedError(f"{what} {name} is not ported")
    return cls


def _massdef(md):
    return MassDef(md.Delta, md.rho_type)


def _concentration(rel):
    """The port's concentration relation with the JAX one's fields."""
    cls = _port_class(rel, _conc, "concentration relation")
    if isinstance(rel, getattr(_conc, "GenericConcentration")) or \
            hasattr(rel, "base"):
        new = object.__new__(cls)
        object.__setattr__(new, "base", _concentration(rel.base))
        object.__setattr__(new, "mass_def", _massdef(rel.mass_def))
        object.__setattr__(new, "n_grid", int(rel.n_grid))
        return new
    kw = {f.name: _value(getattr(rel, f.name))
          for f in dataclasses.fields(rel)}
    return cls(**kw)


def _is_jax_profile(v):
    return hasattr(v, "model_param_names") and hasattr(v, "_real") \
        and not isinstance(v, _base.Profile)


def _value(v):
    """One attribute value of a JAX-package object, in the port's terms."""
    if _is_jax_profile(v):
        return profile_from_jax(v)
    if hasattr(v, "Delta") and hasattr(v, "rho_type"):
        return _massdef(v)
    if isinstance(v, type):
        if hasattr(v, "_concentration") or hasattr(v, "n_grid"):
            return _port_class(v, _conc, "concentration relation")
        return v
    if hasattr(v, "_concentration") or hasattr(v, "base") and \
            hasattr(v, "n_grid"):
        return _concentration(v)
    if isinstance(v, dict):
        return {k: _value(x) for k, x in v.items()}
    if type(v).__module__.split(".")[0] in ("jax", "jaxlib"):
        a = np.asarray(v)
        return a.item() if a.ndim == 0 else a
    return v


def profile_from_jax(prof):
    """The port's counterpart of a JAX-package Schneider19 profile (or a
    combined profile built from them): same class, every attribute carried
    across, sub-profiles converted recursively. A user ``xi_mm`` hook is
    not carried (it would be a JAX callable): such a profile raises."""
    if type(prof).__name__ == "_CombinedProfile":
        cls = _base._CombinedProfile
    else:
        cls = _port_class(prof, _s19, "profile class")
    if getattr(prof, "xi_mm", None) is not None:
        raise NotImplementedError("profile_from_jax: an xi_mm hook cannot "
                                  "be carried across")
    new = object.__new__(cls)
    for k, v in vars(prof).items():
        setattr(new, k, _value(v))
    return new


def baryonification_from_jax(model, device="cuda"):
    """The port's Baryonification2D/3D for a JAX-package model: its table
    when it has one (built or loaded), and its DMO/DMB profiles when it has
    them. ``device`` is where the port's ``setup_interpolator`` runs."""
    cls = Baryonification2D if model._projected else Baryonification3D
    dmo = profile_from_jax(model.DMO) if model.DMO is not None else None
    dmb = profile_from_jax(model.DMB) if model.DMB is not None else None
    new = cls(dmo, dmb, cosmology_from_jax(model.cosmo),
              epsilon_max=model.epsilon_max,
              mass_def=_massdef(model.mass_def),
              r_min_int=model.r_min_int, r_max_int=model.r_max_int,
              N_int=model.N_int, device=device)
    if not hasattr(model, "raw_input_d"):
        return new
    p_keys = [str(k) for k in model.p_keys]
    return new._set_table(
        model.raw_input_d, model.raw_input_z_range, model.raw_input_M_range,
        model.raw_input_r_range, p_keys,
        [getattr(model, f"raw_input_{k}_range") for k in p_keys],
        model.Rdelta_sampling)
