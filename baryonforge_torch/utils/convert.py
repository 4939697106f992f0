"""Carry JAX-package objects across to the port, without importing jax.

The JAX package keeps its state in numpy arrays, plain numbers and small
Python objects, so they convert by reading attributes:

  * ``cosmology_from_jax(cosmo)``: the port's Cosmology;
  * ``profile_from_jax(prof)``: the port's counterpart of a Schneider19
    or thermodynamic profile, with its nested sub-profiles and combined
    (algebra) profiles, model and hyper parameters, FFTLog precision, mass
    definition and concentration relation; also of a ConvolvedProfile and
    its pixel window;
  * ``baryonification_from_jax(model)``: the port's displacement model,
    with its table when it has one and its DMO/DMB profiles when it has
    them;
  * ``tabulated_from_jax(tab)``: the port's TabulatedProfile or
    ParamTabulatedProfile with the JAX object's tables, axes and p_keys,
    and its model when that converts.
"""

import dataclasses

import numpy as np

from ..cosmo import concentration as _conc
from ..cosmo.core import Cosmology
from ..cosmo.massdef import MassDef
from ..Profiles import Base as _base
from ..Profiles import Schneider19 as _s19
from ..Profiles import Thermodynamic as _thermo
from ..Profiles.BaryonCorrection import Baryonification2D, Baryonification3D
from . import Pixel as _pixel
from . import Tabulate as _tabulate

__all__ = ["cosmology_from_jax", "profile_from_jax", "pixel_from_jax",
           "baryonification_from_jax", "tabulated_from_jax"]

# the port's module for each JAX profile module it has a counterpart of
_PROFILE_MODULES = {"Schneider19": _s19, "Thermodynamic": _thermo}


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
    kw = {f.name: _value(getattr(rel, f.name), {})
          for f in dataclasses.fields(rel)}
    return cls(**kw)


def _is_jax_profile(v):
    return hasattr(v, "model_param_names") and hasattr(v, "_real") \
        and not isinstance(v, _base.Profile)


def _value(v, memo):
    """One attribute value of a JAX-package object, in the port's terms;
    ``memo`` maps the ids of profiles converted so far to their
    counterparts, so that a profile met twice (a thermodynamic profile's
    ``prof4params``) converts to one object."""
    if _is_jax_profile(v):
        return profile_from_jax(v, memo)
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
        return {k: _value(x, memo) for k, x in v.items()}
    if type(v).__module__.split(".")[0] in ("jax", "jaxlib"):
        a = np.asarray(v)
        return a.item() if a.ndim == 0 else a
    return v


def pixel_from_jax(pix):
    """The port's pixel window for a JAX-package one."""
    name = type(pix).__name__
    if name == "HealPixel":
        return _pixel.HealPixel(pix.NSIDE)
    if name == "GridPixelApprox":
        return _pixel.GridPixelApprox(pix.size)
    if name == "NoPix":
        return _pixel.NoPix()
    raise NotImplementedError(f"pixel window {name} is not ported")


def profile_from_jax(prof, memo=None):
    """The port's counterpart of a JAX-package Schneider19 or
    thermodynamic profile (or a combined profile built from them): same
    class, every attribute carried across, sub-profiles converted
    recursively. A ConvolvedProfile converts with its profile and pixel
    window. A user ``xi_mm`` hook is not carried (it would be a JAX
    callable): such a profile raises."""
    memo = {} if memo is None else memo
    if id(prof) in memo:
        return memo[id(prof)]
    name = type(prof).__name__
    if name == "ConvolvedProfile":
        new = _pixel.ConvolvedProfile(profile_from_jax(prof.Profile, memo),
                                      pixel_from_jax(prof.Pixel))
        memo[id(prof)] = new
        return new
    if name == "_CombinedProfile":
        cls = _base._CombinedProfile
    else:
        module = _PROFILE_MODULES.get(type(prof).__module__.split(".")[-1])
        if module is None:
            raise NotImplementedError(f"profile class {name} is not ported")
        cls = _port_class(prof, module, "profile class")
    if getattr(prof, "xi_mm", None) is not None:
        raise NotImplementedError("profile_from_jax: an xi_mm hook cannot "
                                  "be carried across")
    new = object.__new__(cls)
    memo[id(prof)] = new
    for k, v in vars(prof).items():
        setattr(new, k, _value(v, memo))
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


def tabulated_from_jax(tab, device="cuda"):
    """The port's TabulatedProfile or ParamTabulatedProfile for a JAX one:
    its tables and axes (as numpy float64), its ``raw_input_*`` arrays and
    p_keys, and its model when that converts (else None: the table reads
    back, but ``setup_interpolator`` then needs a model). ``device`` is
    where the port's ``setup_interpolator`` runs."""
    cls = _port_class(tab, _tabulate, "tabulated profile")
    try:
        model = profile_from_jax(tab.model)
    except NotImplementedError:
        model = None
    new = object.__new__(cls)
    _tabulate._Tabulated.__init__(new, model, cosmology_from_jax(tab.cosmo),
                                  _massdef(tab.mass_def), device)
    new.p_keys = [str(k) for k in tab.p_keys]
    for k, v in vars(tab).items():
        if k.startswith("raw_input_"):
            setattr(new, k, np.asarray(v))
    if hasattr(tab, "_tab2D"):
        new._set_axes([np.array(x, dtype=np.float64) for x in tab._axes],
                      np.array(tab._tab3D, dtype=np.float64),
                      np.array(tab._tab2D, dtype=np.float64))
    return new
