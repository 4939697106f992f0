"""Array-keyed memoization of profile evaluations (port of
``baryonforge_tpu.utils.Cache``; reference utils/Cache.py).

The key is built from the inputs' bytes, shape and dtype, as the JAX
package builds it from numpy bytes (``Cache.py:25-31``); a tensor's key
also names its device, since the value comes back on it. So a tensor on
the card costs one device-to-host copy a call to be keyed. The value is
kept where the profile returned it, a tensor on the caller's device (the
JAX package keeps a host copy, ``:50-60``): a hit makes no host-to-device
copy. The cache keeps its own copy of a value and a hit returns a copy of
that, so that changing a returned tensor in place changes neither the
cache nor a later hit; a hit equals the miss (``torch.equal``).
"""

import threading
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["SimpleArrayCache", "CachedProfile", "CachedHODProfile"]


def _part(x):
    """(bytes, shape, dtype, device) of one argument: a tensor copied to
    the host, anything else through numpy (device None)."""
    if isinstance(x, torch.Tensor):
        h = x.detach().cpu().contiguous().numpy()
        return (h.tobytes(), h.shape, str(h.dtype), str(x.device))
    h = np.asarray(x)
    return (h.tobytes(), h.shape, str(h.dtype), None)


def _copy(v):
    return v.clone() if isinstance(v, torch.Tensor) else np.copy(v)


class SimpleArrayCache:
    """LRU cache keyed on array contents/shape/dtype (and a tensor's
    device) (reference Cache.py:9-109). Thread-safe: one lock guards the
    store."""

    def __init__(self, maxsize=64):
        self.maxsize = maxsize
        self._store = OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def _key(args, kwargs):
        return tuple(_part(x) for x in
                     list(args) + [v for _, v in sorted(kwargs.items())])

    def get(self, key):
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
                return self._store[key]
        return None

    def put(self, key, value):
        with self._lock:
            self._store[key] = value
            self._store.move_to_end(key)
            if len(self._store) > self.maxsize:
                self._store.popitem(last=False)

    def clear(self):
        with self._lock:
            self._store.clear()

    def __len__(self):
        return len(self._store)


def _cached_call(cache, name, args, kw, call):
    """``call()`` memoized in ``cache`` under ``name`` and the arrays
    ``args`` and ``kw`` (a leading cosmology is not keyed, as in the JAX
    package)."""
    key = (name,) + SimpleArrayCache._key(args, kw)
    hit = cache.get(key)
    if hit is not None:
        return _copy(hit)
    out = call()
    cache.put(key, _copy(out))
    return out


class CachedProfile:
    """Wrap a profile, memoizing real/projected/fourier (and a
    displacement model's ``displacement``) on array inputs (reference
    Cache.py:112-158). Any other attribute is the profile's."""

    def __init__(self, profile, maxsize=64):
        self.Profile = profile
        self.cache = SimpleArrayCache(maxsize=maxsize)
        for name in ("real", "projected", "fourier"):
            setattr(self, name, self._memoized(name, getattr(profile, name)))
        if hasattr(profile, "displacement"):
            def displacement(r, M, a, **kw):
                return _cached_call(self.cache, "displacement", (r, M, a),
                                    kw, lambda: profile.displacement(
                                        r, M, a, **kw))
            self.displacement = displacement

    def _memoized(self, name, fn):
        def wrapper(cosmo, r, M, a, **kw):
            return _cached_call(self.cache, name, (r, M, a), kw,
                                lambda: fn(cosmo, r, M, a, **kw))
        return wrapper

    def __getattr__(self, name):
        try:
            return super().__getattribute__(name)
        except AttributeError:
            return getattr(self.Profile, name)


# HOD profiles are CCL-specific in the reference (Cache.py:161-175);
# here any profile-like object works through CachedProfile directly.
CachedHODProfile = CachedProfile
