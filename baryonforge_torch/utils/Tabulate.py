"""Recursive parameter plumbing over nested profiles (the part of
``baryonforge_tpu.utils.Tabulate`` the table build needs;
``TabulatedProfile`` is not ported yet)."""

__all__ = ["_set_parameter", "_get_parameter"]


def _walk_profiles(obj, seen=None):
    """Yield obj and every nested Profile attribute, recursively."""
    from ..Profiles.Base import Profile
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


def _get_parameter(obj, key):
    """Read ``key`` from obj or the first nested profile that has it."""
    for o in _walk_profiles(obj):
        if key in vars(o):
            return getattr(o, key)
    raise AttributeError(f"parameter {key} not found on {obj}")
