"""Recursive parameter plumbing over nested profiles, and the table
grids.

A frozen copy of the plain (CPU) version in ``baryonforge_torch/utils/Tabulate.py`` at
the commit that added the benchmark, with the kernel wrappers left out, so
that it runs in plain PyTorch on any device. It is the benchmark's
reference: it imports nothing of the program and is not edited with it.
"""

import numpy as np


def _walk_profiles(obj, seen=None):
    """Yield obj and every nested Profile attribute, recursively."""
    from .profile_base import Profile
    if seen is None:
        seen = set()
    if id(obj) in seen:
        return
    seen.add(id(obj))
    yield obj
    for v in vars(obj).values():
        if isinstance(v, Profile):
            yield from _walk_profiles(v, seen)


def _set_parameter(obj, key, value):
    """Set ``key`` on obj and every nested profile that defines it
    (reference Tabulate.py:11-64); True when any did."""
    found = False
    for o in _walk_profiles(obj):
        if key in vars(o):
            setattr(o, key, value)
            found = True
    return found


def _grids(z_min, z_max, N_samples_z, M_min, M_max, N_samples_Mass, R_min,
           R_max, N_samples_R, z_linear_sampling):
    """The table's z, M and r grids, in numpy as the JAX package makes
    them."""
    M_range = np.geomspace(M_min, M_max, N_samples_Mass)
    r = np.geomspace(R_min, R_max, N_samples_R)
    z_range = (np.linspace(z_min, z_max, N_samples_z) if z_linear_sampling
               else np.geomspace(z_min, z_max, N_samples_z))
    return z_range, M_range, r
